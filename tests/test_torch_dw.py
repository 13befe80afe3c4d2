"""K3 (the sparse-conv weight gradient) and K2 (the sparse max / sum pool)
over K1's neighbour map, on the CPU: the plain K3 in bf16 against the
Pallas kernel it replaces (`btcdet_tpu/ops/pallas_conv.py::_fused_call_dw`,
interpret mode) at 1e-4 of the output's max; the map-driven plain
versions against the search-driven (rulebook) ones they replaced; K3's
per-tap compaction; and the pools of the det backbone reading the map that
the trunk's strided conv built."""

import numpy as np
import pytest
import torch

from btcdet_tpu.ops import pallas_conv as JP
from btcdet_tpu.ops import sparse as JS
from btcdet_tpu_torch.ops import cuda_conv, cuda_pool
from btcdet_tpu_torch.ops import sparse as TS
from test_torch_sparse import MAP_CASES, MAP_IDS, make_pair
import torch_parity  # noqa: F401,E402  (caps torch's threads in this process)


def _interpret(fn):
    """Run fn() with the Pallas conv kernels in interpret mode."""
    orig, orig_dw = JP._fused_call, JP._fused_call_dw
    try:
        JP._fused_call = lambda *a, **k: orig(*a, **{**k, "interpret": True})
        JP._fused_call_dw = lambda *a, **k: orig_dw(*a, **{**k, "interpret": True})
        return fn()
    finally:
        JP._fused_call, JP._fused_call_dw = orig, orig_dw


@pytest.mark.parametrize("strided", [False, True], ids=["subm", "strided"])
def test_plain_dw_matches_pallas_dw_kernel(strided):
    """The plain K3 on bf16 features equals the Pallas dW kernel: both round
    the gathered rows and g to bf16 and accumulate in f32, so every product
    is exact and only the order of the f32 sums differs (rtol 1e-4, atol
    1e-4 of the output's max)."""
    import jax.numpy as jnp

    cin, cout = 16, 24
    jst, tst = make_pair(seed=31, n=1200, C=cin)
    w = jnp.zeros((27, cin, cout), jnp.float32)            # the df's weights; unused here
    rng = np.random.RandomState(32)
    if strided:
        keys, coords, _, out_shape = JS.conv_output_sites(jst, 3, 2, 1, jst.capacity)
        g = rng.randn(keys.shape[0], cout).astype(np.float32)
        qk, G, TPG = JP.qkeys_conv(coords, keys != JS.INT32_MAX, jst.spatial_shape,
                                   jst.batch_size, 3, 2, 1, 128)
        _, ref = _interpret(lambda: JP.strided_conv_bwd(
            jst.features, jst.keys, qk, w, jnp.asarray(g), keys, jst.coords, jst.valid,
            tuple(int(v) for v in out_shape), jst.batch_size, (3, 3, 3), (2, 2, 2), (1, 1, 1),
            G=G, TPG=TPG, T=128, WIN=128, NB=6, perm=JP.tap_perm(3)))
        out_coords, stride = torch.tensor(np.asarray(coords)), 2
    else:
        g = rng.randn(jst.capacity, cout).astype(np.float32)
        qk, G, TPG = JP.qkeys_subm(jst.coords, jst.valid, jst.spatial_shape, jst.batch_size,
                                   3, 256)
        _, ref = _interpret(lambda: JP.subm_conv_bwd(
            jst.features, jst.keys, qk, w, jnp.asarray(g), G=G, TPG=TPG, T=256, WIN=128, NB=6,
            M=jst.capacity, perm=JP.tap_perm(3)))
        out_coords, stride = tst.coords, 1
    ref = np.asarray(ref)
    out = cuda_conv.sparse_conv_dw_plain(tst.features.to(torch.bfloat16), tst.keys, out_coords,
                                         torch.from_numpy(g), tst.spatial_shape, tst.batch_size,
                                         3, stride, 1).numpy()
    assert out.shape == ref.shape == (27, cin, cout)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    assert np.abs(ref).max() > 1.0


def _rulebook_dw(features, in_keys, out_coords, g, shape, kernel, stride, padding):
    """K3's plain version as it was before it read the map: the rulebook's
    pair search, gather, then the transpose bmm, g in f32."""
    idx, found = cuda_conv.conv_rulebook(in_keys, out_coords, shape, kernel, stride, padding)
    a = features.float()[idx]
    a = torch.where(found[..., None], a, torch.zeros(()))
    return torch.bmm(a.transpose(1, 2), g.float()[None].expand(a.shape[0], *g.shape))


def _rulebook_pool(features, in_keys, out_coords, shape, kernel, stride, padding, mode):
    """K2's plain versions as they were before they read the map."""
    idx, found = cuda_conv.conv_rulebook(in_keys, out_coords, shape, kernel, stride, padding)
    if mode == "max":
        g = torch.where(found[..., None], features[idx], torch.finfo(features.dtype).min)
        return torch.where(found.any(0)[:, None], g.amax(0), torch.zeros(()))
    out = torch.zeros((out_coords.shape[0], features.shape[1]))
    for k in range(idx.shape[0]):
        out = out + torch.where(found[k, :, None], features[idx[k]], torch.zeros(()))
    return out


FORWARD_MAPS = [(c, i) for c, i in zip(MAP_CASES, MAP_IDS) if not c[3]]
POOL_MAPS = [(c, i) for c, i in FORWARD_MAPS if c[1] != 1]


def _sites(tst, kernel, stride, padding):
    if stride == 1:
        return tst.coords
    return TS.conv_output_sites(tst, kernel, stride, padding, tst.capacity)[1]


@pytest.mark.parametrize("kernel,stride,padding,transpose", [c for c, _ in FORWARD_MAPS],
                         ids=[i for _, i in FORWARD_MAPS])
def test_map_dw_matches_rulebook_dw(kernel, stride, padding, transpose):
    """f32: the map-driven plain K3 (the forward's map, as the backward
    passes it) equals the rulebook-driven one to 1e-5 of the max."""
    _, tst = make_pair(seed=33, C=8)
    coords = _sites(tst, kernel, stride, padding)
    g = torch.from_numpy(np.random.RandomState(34).randn(coords.shape[0], 16).astype(np.float32))
    args = (tst.features, tst.keys, coords, g, tst.spatial_shape, tst.batch_size, kernel, stride,
            padding)
    nbr = cuda_conv.neighbor_map(tst.keys, coords, tst.spatial_shape, tst.batch_size, kernel,
                                 stride, padding)
    ref = _rulebook_dw(tst.features, tst.keys, coords, g, tst.spatial_shape, kernel, stride,
                       padding)
    scale = float(ref.abs().max())
    for out in (cuda_conv.sparse_conv_dw(*args, nbr=nbr), cuda_conv.sparse_conv_dw_plain(*args)):
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-5 * scale)
    assert scale > 1.0


@pytest.mark.parametrize("mode", ["max", "sum"])
@pytest.mark.parametrize("kernel,stride,padding,transpose", [c for c, _ in POOL_MAPS],
                         ids=[i for _, i in POOL_MAPS])
def test_map_pools_match_rulebook_pools(kernel, stride, padding, transpose, mode):
    """The map-driven plain K2 max and sum equal the rulebook-driven ones
    bit for bit (the same rows, reduced in the same tap order)."""
    _, tst = make_pair(seed=35, C=2)
    feats = tst.features.abs()                                   # occ codes are >= 0
    coords = _sites(tst, kernel, stride, padding)
    nbr = cuda_conv.neighbor_map(tst.keys, coords, tst.spatial_shape, tst.batch_size, kernel,
                                 stride, padding)
    args = (feats, tst.keys, coords, tst.spatial_shape)
    ref = _rulebook_pool(*args, kernel, stride, padding, mode)
    wrapper, plain = ((cuda_pool.sparse_pool, cuda_pool.sparse_pool_plain) if mode == "max"
                      else (cuda_pool.sparse_sum_pool, cuda_pool.sparse_sum_pool_plain))
    assert torch.equal(plain(*args, kernel, stride, padding, nbr), ref)
    assert torch.equal(plain(*args, kernel, stride, padding), ref)
    assert torch.equal(wrapper(*args, tst.batch_size, kernel, stride, padding, nbr=nbr), ref)
    assert float(ref.max()) > 0


def test_tap_pairs_plain_lists_each_taps_matches():
    """K3's compaction, plain version: tap k's matched (input row, output
    row) pairs in ascending output row, -1 past its count; an empty tap and
    a full tap included."""
    nbr = torch.tensor([[-1, -1, -1, -1, -1], [4, 0, 3, 1, 2], [-1, 7, -1, -1, 5]],
                       dtype=torch.int32)
    pairs, counts = cuda_conv.tap_pairs(nbr)
    assert counts.tolist() == [0, 5, 2] and pairs.shape == (3, 5, 2)
    assert (pairs[0] == -1).all()
    assert pairs[1].tolist() == [[4, 0], [0, 1], [3, 2], [1, 3], [2, 4]]
    assert pairs[2, :2].tolist() == [[7, 1], [5, 4]] and (pairs[2, 2:] == -1).all()


def _count_maps(monkeypatch):
    builds, orig = [], cuda_conv.neighbor_map

    def counting(*a, **k):
        builds.append(tuple(a[4:7]))
        return orig(*a, **k)

    monkeypatch.setattr(cuda_conv, "neighbor_map", counting)
    return builds


@pytest.mark.parametrize("pool", ["max", "fix", "avgpool"])
def test_pools_read_the_trunk_map(monkeypatch, pool):
    """An occ-code pool after the trunk's strided conv, reading a table that
    shares the trunk's keys (as `x_occ` does): at k=3 (SparseMaxPool3d,
    FixedSparseConv3d `fix`) it builds no map and reads the conv's, at k=2
    (`avgpool`) it builds one of its own; either way its output equals the
    pool over its own pair search bit for bit."""
    _, tst = make_pair(seed=36, C=8)
    builds = _count_maps(monkeypatch)
    cache = {}
    occ = tst.replace(features=tst.features[:, :2].abs())
    with torch.no_grad():
        TS.SparseConv3d(8, 8, 3, 2, 1, indice_key="spconv2")(tst, cache)
        assert len(builds) == 1
        if pool == "max":
            mod = TS.SparseMaxPool3d(3, 2, 1, indice_key="spconv2")
        else:
            k = 3 if pool == "fix" else 2
            mod = TS.FixedSparseConv3d(k, 2, 1, indice_key="spconv2", default_value=1.0)
        out = mod(occ, cache)
    assert len(builds) == (2 if pool == "avgpool" else 1)
    if pool == "avgpool":
        assert builds[1][0] == (2, 2, 2)
    keys, coords, _, _ = cache[("sites", "spconv2")]
    assert out.keys is keys
    k = mod.kernel_size
    ref = _rulebook_pool(occ.features, occ.keys, coords, occ.spatial_shape, k, 2, 1,
                         "max" if pool == "max" else "sum")
    assert torch.equal(out.features, ref) and float(ref.max()) > 0
