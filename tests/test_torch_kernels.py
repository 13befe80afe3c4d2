"""The port's CUDA kernels against their plain PyTorch versions on the
card: K1 (`ops/cuda_conv.neighbor_map`, bit for bit, and the gather-GEMM
`sparse_conv`, bf16 on the tensor cores and f32, and `sparse_conv_df` in
transpose-query mode), K3 (`ops/cuda_conv.sparse_conv_dw` and its per-tap
compaction `tap_pairs`, over the map), K2 max and sum over the map
(`ops/cuda_pool.sparse_pool` / `sparse_sum_pool`) and their backward
(`sparse_pool_grad` / `sparse_sum_pool_grad`, bit for bit), K4
(`ops/cuda_interp.trilinear_pool`) and K4's volume gradient
(`ops/cuda_interp.trilinear_pool_grad`). Tests marked `cuda` skip where no
card is present; run them on a GPU machine with
`python -m pytest tests/test_torch_kernels.py -m cuda`."""

import numpy as np
import pytest
import torch

from btcdet_tpu_torch.ops import cuda_conv, cuda_interp, cuda_pool
from btcdet_tpu_torch.ops import sparse as TS

# kernel vs plain: the same products, summed in another order in f32
TOL = dict(rtol=1e-3, atol=1e-3)

CONV_CASES = [  # kernel, stride, padding, Cin, Cout (the flagship backbone's shapes)
    (3, 1, 1, 4, 16), (3, 1, 1, 16, 16), (3, 2, 1, 16, 32), (3, 2, (0, 1, 1), 64, 64),
    ((3, 1, 1), (2, 1, 1), 0, 64, 128), ((2, 1, 1), (2, 1, 1), 0, 128, 64),
    (3, 1, 1, 256, 128), (3, 1, 1, 5, 24),
    # the full config: conv1 on voxel features + occ code, conv2_combine_0
    # on x_conv2 + the pooled occ code
    (3, 1, 1, 6, 16), (3, 1, 1, 34, 32),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _sparse_case(device, cin, seed=0, n=20000, shape=(41, 160, 140), batch=2):
    rng = np.random.RandomState(seed)
    c = np.stack([rng.randint(0, batch, n), rng.randint(0, shape[0], n),
                  rng.randint(0, shape[1], n), rng.randint(0, shape[2], n)], 1)
    c = np.unique(c, axis=0).astype(np.int32)
    c = np.concatenate([c, np.full((777, 4), -1, np.int32)])
    f = rng.randn(len(c), cin).astype(np.float32)
    f[c[:, 0] < 0] = 0
    return TS.from_coords(torch.from_numpy(f).to(device), torch.from_numpy(c).to(device),
                          shape, batch)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("kernel,stride,padding,cin,cout", CONV_CASES)
def test_sparse_conv_kernel_matches_plain(cuda, kernel, stride, padding, cin, cout, dtype):
    st = _sparse_case(cuda, cin)
    if stride == 1:
        coords = st.coords
    else:
        _, coords, _, _ = TS.conv_output_sites(st, kernel, stride, padding, st.capacity)
    K = int(np.prod(cuda_conv.triple(kernel)))
    w = (torch.randn(K, cin, cout, generator=torch.Generator().manual_seed(1))
         / np.sqrt(K * cin)).to(cuda, dtype)
    feats = st.features.to(dtype)
    args = (st.keys, coords, w, st.spatial_shape, st.batch_size, kernel, stride, padding)
    n0 = cuda_conv.launches
    out = cuda_conv.sparse_conv(feats, *args)
    torch.cuda.synchronize()
    assert cuda_conv.launches == n0 + 1
    ref = cuda_conv.sparse_conv_plain(feats, *args)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    torch.testing.assert_close(out, ref, **TOL)
    assert (out[(coords[:, 0] < 0)] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_trilinear_pool_kernel_matches_plain(cuda, dtype):
    g = torch.Generator().manual_seed(2)
    B, D, H, W, C, R, S = 2, 5, 200, 176, 128, 40, 2592
    vol = torch.randn(B, D, H, W, C, generator=g).to(cuda, dtype)
    centers = torch.rand(R, 2, generator=g) * torch.tensor([H - 20.0, W - 20.0]) + 10
    zyx = torch.cat([torch.rand(R, S, 1, generator=g) * (D + 2) - 1,
                     centers[:, None] + (torch.rand(R, S, 2, generator=g) - 0.5) * 30], -1)
    zyx = zyx.to(cuda)
    roi_b = torch.randint(0, B, (R,), generator=g).to(cuda)
    valid = (torch.rand(R, S, generator=g) < 0.9).to(cuda)
    n0 = cuda_interp.launches
    out = cuda_interp.trilinear_pool(vol, zyx, roi_b, valid)
    torch.cuda.synchronize()
    assert cuda_interp.launches == n0 + 1
    ref = cuda_interp.trilinear_pool_plain(vol, zyx, roi_b, valid)
    assert out.dtype == ref.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    else:
        assert_within_one_bf16_ulp(out, ref)


def bf16_ulp(x):
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    a = x.float().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def assert_within_one_bf16_ulp(out, ref):
    """Both add the same 8 weighted corners in the same order in f32 and
    round once to bf16; a sum whose last f32 bit differed would move the
    rounding by at most one bf16 ulp (the kernel keeps the plain version's
    f32 steps, so it matches bit for bit)."""
    diff = (out.float() - ref.float()).abs()
    ulp = torch.maximum(bf16_ulp(out), bf16_ulp(ref))
    assert bool((diff <= ulp).all()), float((diff / ulp).max())


def _k4_grad_case(device, C, R=40, S=2592, seed=5, shape=(2, 5, 200, 176), spread=30.0,
                  one_center=False):
    """ConvHead-like samples (clustered per roi within `spread` cells, all
    rois around one point if `one_center`, some corners outside the
    volume, some samples invalid) and an output gradient; K4's volume
    gradient inputs."""
    g = torch.Generator().manual_seed(seed)
    B, D, H, W = shape
    centers = torch.rand(R, 2, generator=g) * torch.tensor([H - 20.0, W - 20.0]) + 10
    if one_center:
        centers = centers[:1].expand(R, 2)
    zyx = torch.cat([torch.rand(R, S, 1, generator=g) * (D + 2) - 1,
                     centers[:, None] + (torch.rand(R, S, 2, generator=g) - 0.5) * spread], -1)
    zyx[0, :7] = torch.tensor([0.0, 3.0, 4.0])      # on grid points: zero-weight corners
    roi_b = torch.randint(0, B, (R,), generator=g)
    valid = torch.rand(R, S, generator=g) < 0.9
    grad_out = torch.randn(R, S, C, generator=g)
    return [t.to(device) for t in (grad_out, zyx, roi_b, valid)], (B, D, H, W, C)


@pytest.mark.cuda
@pytest.mark.parametrize("C,R,hot", [(128, 40, False), (8, 12, False), (24, 12, False),
                                     (264, 12, False), (32, 12, True), (8, 40, True)])
def test_trilinear_pool_grad_kernel_matches_plain(cuda, C, R, hot):
    """K4's volume gradient (`trilinear_pool_bwd`) against the plain
    `index_add_` version on the same bf16-valued gradient: in f32 within
    1e-5 of the plain output's max (the same f32 products summed in
    another order) and no further from a float64 sum than the plain
    version is; in bf16 the f32 result rounded once (equal to the f32
    kernel's output cast to bf16, so within one bf16 ulp of the plain
    version's cast wherever the two f32 sums round alike); the same bits
    on a repeat. The `hot` cases pile all rois' samples into a few cells,
    thousands of entries a cell: segments longer than a warp sorts in
    shared memory (12 rois: up to 2 678 entries, sorted by a block in
    shared memory; 40 rois: up to 9 154, past that too)."""
    (gout, zyx, roi_b, valid), shape = _k4_grad_case(cuda, C, R=R, spread=2.0 if hot else 30.0,
                                                     one_center=hot)
    g16 = gout.to(torch.bfloat16)
    n0 = cuda_interp.bwd_launches
    out32 = cuda_interp.trilinear_pool_grad(g16.float(), shape, torch.float32, zyx, roi_b, valid)
    out16 = cuda_interp.trilinear_pool_grad(g16, shape, torch.bfloat16, zyx, roi_b, valid)
    again = cuda_interp.trilinear_pool_grad(g16, shape, torch.bfloat16, zyx, roi_b, valid)
    torch.cuda.synchronize()
    assert cuda_interp.bwd_launches == n0 + 3
    assert out16.dtype == torch.bfloat16 and out16.shape == shape and out16.is_contiguous()
    assert torch.equal(out16, again)
    assert torch.equal(out16, out32.to(torch.bfloat16))
    ref32 = cuda_interp.trilinear_pool_volume_grad(g16, shape, zyx, roi_b, valid)
    scale = float(ref32.abs().max())
    assert scale > 0.5
    assert float((out32 - ref32).abs().max()) <= 1e-5 * scale
    exact = cuda_interp.trilinear_pool_volume_grad(g16, shape, zyx, roi_b, valid,
                                                   torch.float64)
    assert float((out32.double() - exact).abs().max()) <= float((ref32.double() - exact)
                                                                .abs().max())
    untouched = exact.abs().sum(-1) == 0
    assert bool(untouched.any()) and bool((out16[untouched] == 0).all())


@pytest.mark.cuda
def test_trilinear_pool_grad_kernel_on_an_empty_call(cuda):
    """No valid sample: the kernel writes an all-zero volume."""
    (gout, zyx, roi_b, valid), shape = _k4_grad_case(cuda, 16, R=3, S=50, shape=(1, 3, 8, 8))
    out = cuda_interp.trilinear_pool_grad(gout.to(torch.bfloat16), shape, torch.bfloat16, zyx,
                                          roi_b, torch.zeros_like(valid))
    assert out.shape == shape and bool((out == 0).all())


def test_cpu_tensors_take_the_plain_volume_gradient():
    (gout, zyx, roi_b, valid), shape = _k4_grad_case("cpu", 16, R=3, S=50, shape=(1, 3, 8, 8))
    n0 = cuda_interp.bwd_launches
    out = cuda_interp.trilinear_pool_grad(gout, shape, torch.bfloat16, zyx, roi_b, valid)
    assert cuda_interp.bwd_launches == n0 and out.dtype == torch.bfloat16
    ref = cuda_interp.trilinear_pool_volume_grad(gout, shape, zyx, roi_b, valid)
    assert torch.equal(out, ref.to(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["zyx", "yzx-permuted", "channel-slice"])
def test_trilinear_pool_kernel_on_strided_volumes(cuda, layout):
    """K4 reads the volume in place through its strides (no copy): the
    permuted view of the scatter-native (B, H, D, W, C) table that
    ConvHead passes, and a channel slice of a wider table; bf16 output
    within one bf16 ulp of the plain version's, as on the contiguous
    volume."""
    g = torch.Generator().manual_seed(3)
    B, D, H, W, C, R, S = 2, 5, 200, 176, 128, 24, 2592
    vol = torch.randn(B, D, H, W, C, generator=g).to(cuda, torch.bfloat16)
    if layout == "yzx-permuted":
        vol = vol.permute(0, 2, 1, 3, 4).contiguous().permute(0, 2, 1, 3, 4)
    elif layout == "channel-slice":
        vol = torch.cat([vol, vol[..., :64]], -1)[..., :C]
    assert layout == "zyx" or not vol.is_contiguous()
    centers = torch.rand(R, 2, generator=g) * torch.tensor([H - 20.0, W - 20.0]) + 10
    zyx = torch.cat([torch.rand(R, S, 1, generator=g) * (D + 2) - 1,
                     centers[:, None] + (torch.rand(R, S, 2, generator=g) - 0.5) * 30], -1)
    roi_b = torch.randint(-1, B + 1, (R,), generator=g).to(cuda)
    valid = (torch.rand(R, S, generator=g) < 0.9).to(cuda)
    out = cuda_interp.trilinear_pool(vol, zyx.to(cuda), roi_b, valid)
    ref = cuda_interp.trilinear_pool_plain(vol, zyx.to(cuda), roi_b, valid)
    assert out.dtype == torch.bfloat16 and out.shape == (R, S, C)
    assert_within_one_bf16_ulp(out, ref)
    assert float(ref.float().abs().max()) > 0.5
    outside = (roi_b < 0) | (roi_b >= B)
    assert bool(outside.any()) and bool((out[outside] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,stride,padding,cin,seed", [
    (3, 2, 1, 2, 0), (3, 2, 1, 2, 1), (3, 2, (0, 1, 1), 5, 2), (2, 2, 0, 3, 3)])
def test_sparse_pool_kernel_matches_plain(cuda, kernel, stride, padding, cin, seed):
    """K2 max against its plain version: the same max over the same rows,
    so bit for bit (tolerance 0)."""
    st = _sparse_case(cuda, cin, seed=seed)
    feats = st.features.abs() if seed % 2 else st.features     # occ codes are >= 0
    _, coords, _, _ = TS.conv_output_sites(st, kernel, stride, padding, st.capacity)
    args = (st.keys, coords, st.spatial_shape, st.batch_size, kernel, stride, padding)
    n0 = cuda_pool.launches
    out = cuda_pool.sparse_pool(feats, *args)
    torch.cuda.synchronize()
    assert cuda_pool.launches == n0 + 1
    ref = cuda_pool.sparse_pool_plain(feats, st.keys, coords, st.spatial_shape, kernel, stride,
                                      padding)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert torch.equal(out, ref)
    assert (out[coords[:, 0] < 0] == 0).all()


@pytest.mark.cuda
def test_sparse_pool_kernel_on_all_padding_table(cuda):
    keys = torch.full((256,), cuda_conv.INT32_MAX, dtype=torch.int32, device=cuda)
    feats = torch.rand(256, 2, device=cuda)
    coords = torch.full((300, 4), -1, dtype=torch.int32, device=cuda)
    coords[:10] = torch.tensor([0, 1, 2, 3], dtype=torch.int32, device=cuda)
    out = cuda_pool.sparse_pool(feats, keys, coords, (9, 20, 20), 2, 3, 2, 1)
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,stride,padding,cin,seed", [
    (3, 2, 1, 2, 0), (3, 2, (0, 1, 1), 2, 1), (2, 2, 1, 2, 2), (2, 2, (1, 1, 1), 2, 3),
    (3, 2, 1, 5, 4)], ids=["fix", "fix-level3", "avgpool", "avgpool-level3", "5ch"])
def test_sparse_sum_pool_kernel_matches_plain(cuda, kernel, stride, padding, cin, seed):
    """K2 sum against its plain version: the same rows added in the same
    (tap) order in float32, so bit for bit (tolerance 0), for the `fix`
    (k=3) and `avgpool` (k=2) downsamplers' geometries."""
    st = _sparse_case(cuda, cin, seed=seed)
    feats = st.features.abs()                                  # occ codes are >= 0
    _, coords, _, _ = TS.conv_output_sites(st, 3, stride, (0, 1, 1) if seed % 2 else 1,
                                           st.capacity)
    args = (st.keys, coords, st.spatial_shape, st.batch_size, kernel, stride, padding)
    n0, m0 = cuda_pool.sum_launches, cuda_pool.launches
    out = cuda_pool.sparse_sum_pool(feats, *args)
    torch.cuda.synchronize()
    assert (cuda_pool.sum_launches, cuda_pool.launches) == (n0 + 1, m0)
    ref = cuda_pool.sparse_sum_pool_plain(feats, st.keys, coords, st.spatial_shape, kernel,
                                          stride, padding)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert torch.equal(out, ref)
    assert (out[coords[:, 0] < 0] == 0).all() and float(out.max()) > 1.0


@pytest.mark.cuda
def test_sparse_sum_pool_kernel_on_all_padding_table(cuda):
    keys = torch.full((256,), cuda_conv.INT32_MAX, dtype=torch.int32, device=cuda)
    feats = torch.rand(256, 2, device=cuda)
    coords = torch.full((300, 4), -1, dtype=torch.int32, device=cuda)
    coords[:10] = torch.tensor([0, 1, 2, 3], dtype=torch.int32, device=cuda)
    for kernel in (3, 2):
        out = cuda_pool.sparse_sum_pool(feats, keys, coords, (9, 20, 20), 2, kernel, 2, 1)
        assert torch.equal(out, torch.zeros_like(out))


def _pool_grad_case(device, kind, seed=0):
    """A 2-channel occ-code table (`flags`: 0 / 1 codes, ties everywhere;
    `random`), its strided output sites, both maps and an output gradient."""
    st = _sparse_case(device, 2, seed=seed, n=20000)
    if kind == "flags":
        f = (st.features > 0).float() * (st.coords[:, :1] >= 0)
        st = st.replace(features=f)
    keys, coords, _, out_shape = TS.conv_output_sites(st, 3, 2, 1, 4 * st.capacity)
    nbr = cuda_conv.neighbor_map(st.keys, coords, st.spatial_shape, 2, 3, 2, 1)
    tnbr = cuda_conv.neighbor_map(keys, st.coords, out_shape, 2, 3, 2, 1, transpose=True)
    g = torch.randn(coords.shape[0], 2, device=device,
                    generator=torch.Generator(device=device).manual_seed(seed))
    return st, coords, nbr, tnbr, g


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["flags", "random"])
def test_sparse_sum_pool_grad_kernel_matches_plain(cuda, kind):
    """K2 sum's backward (its forward kernel over the transpose-query map)
    against its plain version, bit for bit, and bit for bit on a repeat;
    the forward wrapper refuses an input that requires a gradient outside
    `sparse.SparsePoolFunction`."""
    st, coords, _, tnbr, g = _pool_grad_case(cuda, kind)
    n0 = cuda_pool.sum_bwd_launches
    df = cuda_pool.sparse_sum_pool_grad(g, tnbr)
    assert torch.equal(df, cuda_pool.sparse_sum_pool_grad_plain(g, tnbr))
    assert torch.equal(df, cuda_pool.sparse_sum_pool_grad(g, tnbr))
    assert cuda_pool.sum_bwd_launches == n0 + 2
    assert (df[st.coords[:, 0] < 0] == 0).all() and (df != 0).any()
    feats = st.features.clone().requires_grad_()
    with pytest.raises(ValueError):
        cuda_pool.sparse_sum_pool(feats, st.keys, coords, st.spatial_shape, 2, 3, 2, 1)


def test_cpu_tensors_take_the_plain_sum_pool():
    """K2 sum's wrapper takes its plain version on CPU tensors and counts no
    launch."""
    st = _sparse_case("cpu", 2, n=300, shape=(9, 20, 20))
    _, coords, _, _ = TS.conv_output_sites(st, 3, 2, 1, st.capacity)
    n0 = cuda_pool.sum_launches
    for kernel in (3, 2):
        out = cuda_pool.sparse_sum_pool(st.features, st.keys, coords, st.spatial_shape, 2, kernel,
                                        2, 1)
        torch.testing.assert_close(out, cuda_pool.sparse_sum_pool_plain(
            st.features, st.keys, coords, st.spatial_shape, kernel, 2, 1), rtol=0, atol=0)
    assert cuda_pool.sum_launches == n0
    assert float(out.abs().max()) > 0


@pytest.mark.cuda
def test_kernels_refuse_bad_inputs(cuda):
    st = _sparse_case(cuda, 8, n=500)
    w = torch.zeros(27, 8, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        cuda_conv.sparse_conv(st.features, st.keys, st.coords, w, st.spatial_shape, 2, 3, 1, 1)
    with pytest.raises(ValueError):
        cuda_conv.sparse_conv(st.features, st.keys, st.coords, w.float()[:9], st.spatial_shape,
                              2, 3, 1, 1)
    with pytest.raises(TypeError):
        cuda_pool.sparse_pool(st.features.half(), st.keys, st.coords, st.spatial_shape, 2, 3, 2, 1)
    with pytest.raises(TypeError):
        cuda_pool.sparse_pool(st.features, st.keys.long(), st.coords, st.spatial_shape, 2, 3, 2, 1)


def test_cpu_tensors_take_the_plain_version():
    st = _sparse_case("cpu", 4, n=300, shape=(9, 20, 20))
    w = torch.randn(27, 4, 8)
    n0 = cuda_conv.launches
    out = cuda_conv.sparse_conv(st.features, st.keys, st.coords, w, st.spatial_shape, 2, 3, 1, 1)
    ref = cuda_conv.sparse_conv_plain(st.features, st.keys, st.coords, w, st.spatial_shape,
                                      2, 3, 1, 1)
    assert cuda_conv.launches == n0
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    n2 = cuda_pool.launches
    out = cuda_pool.sparse_pool(st.features, st.keys, st.coords, st.spatial_shape, 2, 3, 2, 1)
    assert cuda_pool.launches == n2
    torch.testing.assert_close(out, cuda_pool.sparse_pool_plain(
        st.features, st.keys, st.coords, st.spatial_shape, 3, 2, 1), rtol=0, atol=0)
    vol = torch.randn(1, 3, 8, 8, 4)
    zyx = torch.rand(2, 5, 3) * 8
    n1 = cuda_interp.launches
    cuda_interp.trilinear_pool(vol, zyx, torch.zeros(2, dtype=torch.long),
                               torch.ones(2, 5, dtype=torch.bool))
    assert cuda_interp.launches == n1


def _dw_case(device, kernel, stride, padding, cin, cout, dtype, seed=0):
    st = _sparse_case(device, cin, seed=seed)
    if stride == 1:
        coords = st.coords
    else:
        _, coords, _, _ = TS.conv_output_sites(st, kernel, stride, padding, st.capacity)
    g = torch.randn(coords.shape[0], cout, generator=torch.Generator().manual_seed(seed + 1))
    g = torch.where((coords[:, 0] >= 0).cpu()[:, None], g, torch.zeros(()))
    return (st.features.to(dtype), st.keys, coords, g.to(device), st.spatial_shape,
            st.batch_size, kernel, stride, padding)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("kernel,stride,padding,cin,cout", CONV_CASES)
def test_sparse_conv_dw_kernel_matches_plain(cuda, kernel, stride, padding, cin, cout, dtype):
    """K3 against its plain version (gather + bmm of the transpose), and
    bit for bit the same in a second run."""
    args = _dw_case(cuda, kernel, stride, padding, cin, cout, dtype)
    n0 = cuda_conv.dw_launches
    dw = cuda_conv.sparse_conv_dw(*args)
    again = cuda_conv.sparse_conv_dw(*args)
    torch.cuda.synchronize()
    assert cuda_conv.dw_launches == n0 + 2
    ref = cuda_conv.sparse_conv_dw_plain(*args)
    assert dw.dtype == torch.float32 and dw.shape == ref.shape
    scale = float(ref.abs().max())
    torch.testing.assert_close(dw, ref, rtol=1e-3, atol=1e-4 * scale)
    assert torch.equal(dw, again)


@pytest.mark.cuda
def test_sparse_conv_dw_on_all_padding_table(cuda):
    """No live row matches: dW is exactly 0 (every chunk's partial is written)."""
    keys = torch.full((256,), cuda_conv.INT32_MAX, dtype=torch.int32, device=cuda)
    feats = torch.rand(256, 8, device=cuda)
    coords = torch.full((3000, 4), -1, dtype=torch.int32, device=cuda)
    coords[:10] = torch.tensor([0, 1, 2, 3], dtype=torch.int32, device=cuda)
    g = torch.rand(3000, 16, device=cuda)
    dw = cuda_conv.sparse_conv_dw(feats, keys, coords, g, (9, 20, 20), 2, 3, 1, 1)
    assert dw.shape == (27, 8, 16) and torch.equal(dw, torch.zeros_like(dw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("kernel,stride,padding,cin,cout",
                         [c for c in CONV_CASES if c[1] != 1])
def test_sparse_conv_df_transpose_matches_plain(cuda, kernel, stride, padding, cin, cout, dtype):
    """K1 in transpose-query mode (the df of a strided conv) against its
    plain version: input sites read the output table at (s + p - tap) / stride."""
    st = _sparse_case(cuda, cin)
    keys, coords, _, out_shape = TS.conv_output_sites(st, kernel, stride, padding, st.capacity)
    K = int(np.prod(cuda_conv.triple(kernel)))
    g = torch.randn(keys.shape[0], cout, generator=torch.Generator().manual_seed(3)).to(cuda, dtype)
    w_t = (torch.randn(K, cout, cin, generator=torch.Generator().manual_seed(4))
           / np.sqrt(K * cout)).to(cuda, dtype)
    args = (keys, st.coords, w_t, out_shape, st.batch_size, kernel, stride, padding)
    n0 = cuda_conv.df_launches
    out = cuda_conv.sparse_conv_df(g, *args, transpose=True)
    torch.cuda.synchronize()
    assert cuda_conv.df_launches == n0 + 1
    ref = cuda_conv.sparse_conv_plain(g, *args, transpose=True)
    assert out.shape == (st.capacity, cin)
    torch.testing.assert_close(out, ref, **TOL)
    assert float(ref.abs().max()) > 0


def test_cpu_tensors_take_the_plain_backward():
    """The df (K1) and dW (K3) wrappers take their plain versions on CPU
    tensors and count no launch."""
    st = _sparse_case("cpu", 4, n=300, shape=(9, 20, 20))
    g = torch.randn(st.capacity, 8)
    n0, n1 = cuda_conv.df_launches, cuda_conv.dw_launches
    dw = cuda_conv.sparse_conv_dw(st.features, st.keys, st.coords, g, st.spatial_shape, 2, 3, 1, 1)
    torch.testing.assert_close(dw, cuda_conv.sparse_conv_dw_plain(
        st.features, st.keys, st.coords, g, st.spatial_shape, 2, 3, 1, 1), rtol=0, atol=0)
    w_t = torch.randn(27, 8, 4)
    df = cuda_conv.sparse_conv_df(g, st.keys, st.coords, w_t, st.spatial_shape, 2, 3, 1, 1,
                                  transpose=False)
    torch.testing.assert_close(df, cuda_conv.sparse_conv_plain(
        g, st.keys, st.coords, w_t, st.spatial_shape, 2, 3, 1, 1), rtol=0, atol=0)
    assert (cuda_conv.df_launches, cuda_conv.dw_launches) == (n0, n1)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["flags", "random"])
def test_sparse_pool_grad_kernel_matches_plain(cuda, kind):
    """K2 max's backward against its plain version, bit for bit (tied maxima
    split evenly, one division per output in both), and bit for bit on a
    repeat; through `sparse.SparsePoolFunction` on a module the gradient is
    the same; the forward wrapper refuses an input that requires a
    gradient outside it."""
    st, coords, nbr, tnbr, g = _pool_grad_case(cuda, kind)
    out = cuda_pool.sparse_pool(st.features, st.keys, coords, st.spatial_shape, 2, 3, 2, 1,
                                nbr=nbr)
    n0 = cuda_pool.bwd_launches
    df = cuda_pool.sparse_pool_grad(st.features, out, g, nbr, tnbr)
    assert torch.equal(df, cuda_pool.sparse_pool_grad_plain(st.features, out, g, nbr, tnbr))
    assert torch.equal(df, cuda_pool.sparse_pool_grad(st.features, out, g, nbr, tnbr))
    assert cuda_pool.bwd_launches == n0 + 2
    assert (df[st.coords[:, 0] < 0] == 0).all() and (df != 0).any()
    feats = st.features.clone().requires_grad_()
    with pytest.raises(ValueError):
        cuda_pool.sparse_pool(feats, st.keys, coords, st.spatial_shape, 2, 3, 2, 1)
    cache = {}
    TS.SparseConv3d(2, 4, 3, 2, 1, indice_key="spconv2",
                    frame_capacity=(2 * st.capacity, 2 * st.capacity)).to(cuda)(st, cache)
    pooled = TS.SparseMaxPool3d(3, 2, 1, indice_key="spconv2")(st.replace(features=feats), cache)
    site_nbr = cuda_conv.neighbor_map(st.keys, pooled.coords, st.spatial_shape, 2, 3, 2, 1)
    site_tnbr = cuda_conv.neighbor_map(pooled.keys, st.coords, pooled.spatial_shape, 2, 3, 2, 1,
                                       transpose=True)
    gg = torch.randn_like(pooled.features)
    pooled.features.backward(gg)
    assert torch.equal(feats.grad, cuda_pool.sparse_pool_grad_plain(
        st.features, pooled.features.detach(), gg, site_nbr, site_tnbr))


K1_EDGE_CASES = [  # kernel, stride, padding, Cin, Cout: ragged Cin, Cout 8 and 256
    (3, 1, 1, 6, 8), (3, 1, 1, 34, 256), (3, 1, 1, 256, 256), (3, 2, 1, 34, 8),
    ((3, 1, 1), (2, 1, 1), 0, 6, 24), (3, 1, 1, 256, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,stride,padding,cin,cout", K1_EDGE_CASES)
def test_bf16_conv_at_tile_edges(cuda, kernel, stride, padding, cin, cout):
    """The bf16 gather-GEMM at the edges of its tiles: M not a multiple of
    64, Cin not a multiple of 8 (padded by the wrapper) or of the 32-deep
    k-step, Cout 8 and 256; against the plain version, and bit for bit the
    same in a second run (each output element is summed by one warp in a
    fixed order)."""
    st = _sparse_case(cuda, cin, n=5003)
    if stride == 1:
        coords = st.coords
    else:
        _, coords, _, _ = TS.conv_output_sites(st, kernel, stride, padding, st.capacity)
    assert coords.shape[0] % 64 != 0
    K = int(np.prod(cuda_conv.triple(kernel)))
    w = (torch.randn(K, cin, cout, generator=torch.Generator().manual_seed(5))
         / np.sqrt(K * cin)).to(cuda, torch.bfloat16)
    feats = st.features.to(torch.bfloat16)
    args = (st.keys, coords, w, st.spatial_shape, st.batch_size, kernel, stride, padding)
    nbr = cuda_conv.neighbor_map(st.keys, coords, st.spatial_shape, st.batch_size, kernel,
                                 stride, padding)
    out = cuda_conv.sparse_conv(feats, *args, nbr=nbr)
    again = cuda_conv.sparse_conv(feats, *args, nbr=nbr)
    torch.cuda.synchronize()
    ref = cuda_conv.sparse_conv_plain(feats, *args)
    assert out.dtype == torch.float32 and out.shape == ref.shape == (coords.shape[0], cout)
    torch.testing.assert_close(out, ref, **TOL)
    assert torch.equal(out, again)
    assert float(ref.abs().max()) > 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_conv_on_all_padding_table(cuda, dtype):
    """No live input row: the map is all -1 and the conv exactly 0."""
    keys = torch.full((256,), cuda_conv.INT32_MAX, dtype=torch.int32, device=cuda)
    feats = torch.rand(256, 16, device=cuda).to(dtype)
    coords = torch.full((300, 4), -1, dtype=torch.int32, device=cuda)
    coords[:10] = torch.tensor([0, 1, 2, 3], dtype=torch.int32, device=cuda)
    w = torch.rand(27, 16, 32, device=cuda).to(dtype)
    nbr = cuda_conv.neighbor_map(keys, coords, (9, 20, 20), 2, 3, 1, 1)
    assert torch.equal(nbr, torch.full_like(nbr, -1))
    out = cuda_conv.sparse_conv(feats, keys, coords, w, (9, 20, 20), 2, 3, 1, 1)
    assert out.shape == (300, 32) and torch.equal(out, torch.zeros_like(out))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,stride,padding,transpose", [
    (3, 1, 1, False), (3, 2, 1, False), ((3, 1, 1), (2, 1, 1), 0, False),
    ((2, 1, 1), (2, 1, 1), 0, False), (3, 2, (0, 1, 1), False), (3, 2, 1, True),
    (3, 2, (0, 1, 1), True)])
def test_neighbor_map_kernel_matches_plain(cuda, kernel, stride, padding, transpose):
    """The map kernel against its plain version (`where(found, idx, -1)` of
    the rulebook): the same binary-search semantics, so exactly equal."""
    st = _sparse_case(cuda, 2)
    if stride == 1:
        keys, coords, out_shape = st.keys, st.coords, st.spatial_shape
    else:
        keys, coords, _, out_shape = TS.conv_output_sites(st, kernel, stride, padding,
                                                          st.capacity)
    table, queries, shape = ((keys, st.coords, out_shape) if transpose
                             else (st.keys, coords, st.spatial_shape))
    n0 = cuda_conv.nbr_launches
    nbr = cuda_conv.neighbor_map(table, queries, shape, st.batch_size, kernel, stride, padding,
                                 transpose)
    torch.cuda.synchronize()
    assert cuda_conv.nbr_launches == n0 + 1
    ref = cuda_conv.neighbor_map_plain(table, queries, shape, kernel, stride, padding, transpose)
    assert nbr.dtype == torch.int32 and torch.equal(nbr, ref)
    assert int((nbr >= 0).sum()) > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(24, 34), (32, 6)])
def test_bf16_transpose_df_with_ragged_channels(cuda, cin, cout):
    """K1's transpose-query df in bf16 with an output width (the forward's
    Cin) that is not a multiple of 8: the weights are padded to 8."""
    st = _sparse_case(cuda, 2, n=5003)
    keys, coords, _, out_shape = TS.conv_output_sites(st, 3, 2, 1, st.capacity)
    g = torch.randn(keys.shape[0], cin, generator=torch.Generator().manual_seed(6))
    g = g.to(cuda, torch.bfloat16)
    w_t = (torch.randn(27, cin, cout, generator=torch.Generator().manual_seed(7))
           / np.sqrt(27 * cin)).to(cuda, torch.bfloat16)
    args = (keys, st.coords, w_t, out_shape, st.batch_size, 3, 2, 1)
    out = cuda_conv.sparse_conv_df(g, *args, transpose=True)
    ref = cuda_conv.sparse_conv_plain(g, *args, transpose=True)
    assert out.shape == (st.capacity, cout)
    torch.testing.assert_close(out, ref, **TOL)
    assert float(ref.abs().max()) > 0.1


@pytest.mark.cuda
def test_new_kernels_refuse_bad_inputs(cuda):
    """The map, the gather-GEMM and the sampler raise on CUDA inputs they
    do not take; nothing falls back to a plain version."""
    st = _sparse_case(cuda, 8, n=500)
    w = torch.zeros(27, 8, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        cuda_conv.neighbor_map(st.keys.long(), st.coords, st.spatial_shape, 2, 3, 1, 1)
    nbr = cuda_conv.neighbor_map(st.keys, st.coords, st.spatial_shape, 2, 3, 1, 1)
    with pytest.raises(ValueError):
        cuda_conv.sparse_conv(st.features.bfloat16(), st.keys, st.coords, w, st.spatial_shape,
                              2, 3, 1, 1, nbr=nbr.long())
    with pytest.raises(ValueError):
        cuda_conv.sparse_conv(st.features.bfloat16(), st.keys, st.coords, w, st.spatial_shape,
                              2, 3, 1, 1, nbr=nbr[:9])
    with pytest.raises(ValueError):
        cuda_conv.sparse_conv(st.features.bfloat16(), st.keys, st.coords,
                              torch.zeros(27, 8, 264, device=cuda, dtype=torch.bfloat16),
                              st.spatial_shape, 2, 3, 1, 1, nbr=nbr)
    zyx = torch.rand(2, 5, 3, device=cuda) * 8
    roi_b = torch.zeros(2, dtype=torch.long, device=cuda)
    valid = torch.ones(2, 5, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):                      # channel stride 2
        cuda_interp.trilinear_pool(torch.randn(1, 3, 8, 8, 32, device=cuda)[..., ::2], zyx,
                                   roi_b, valid)
    with pytest.raises(ValueError):                      # C not a multiple of 8
        cuda_interp.trilinear_pool(torch.randn(1, 3, 8, 8, 12, device=cuda), zyx, roi_b, valid)


def _map_with_empty_and_full_taps(st, coords, kernel, stride, padding):
    """The map of these pairs with tap 0 emptied and tap 1 matching every
    output row (padding rows too), the compaction's edge cases."""
    nbr = cuda_conv.neighbor_map(st.keys, coords, st.spatial_shape, st.batch_size, kernel,
                                 stride, padding)
    nbr[0] = -1
    nbr[1] = torch.arange(nbr.shape[1], device=nbr.device, dtype=torch.int32) % int(st.nnz)
    return nbr


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 20, 1023, 1024, 5003, 20000])
def test_tap_pairs_kernel_matches_plain(cuda, n):
    """K3's compaction against its plain version on maps of one output row,
    of fewer rows than one 32-pair step, around one 1024-row count block
    and of many blocks, with an empty tap and a full one: the same counts
    and the same pairs in row order (the entries past a count are
    undefined)."""
    st = _sparse_case(cuda, 2, n=n, shape=(41, 160, 140) if n > 100 else (5, 8, 8))
    coords = st.coords[:n]
    nbr = _map_with_empty_and_full_taps(st, coords, 3, 1, 1)
    n0 = cuda_conv.pair_launches
    pairs, counts = cuda_conv.tap_pairs(nbr)
    torch.cuda.synchronize()
    assert cuda_conv.pair_launches == n0 + 1
    ref_pairs, ref_counts = cuda_conv.tap_pairs_plain(nbr)
    assert torch.equal(counts, ref_counts)
    assert counts[0] == 0 and counts[1] == nbr.shape[1]
    for k, c in enumerate(ref_counts.tolist()):
        assert torch.equal(pairs[k, :c], ref_pairs[k, :c]), k


K3_EDGE_CASES = [  # kernel, stride, padding, Cin, Cout, rows: ragged Cin / Cout, Cout 256,
    # fewer rows than one 32-pair step
    (3, 1, 1, 6, 16, 5003), (3, 1, 1, 34, 32, 5003), (3, 1, 1, 16, 6, 5003),
    (3, 1, 1, 256, 256, 5003), (3, 2, 1, 34, 24, 5003), ((3, 1, 1), (2, 1, 1), 0, 6, 128, 5003),
    (3, 1, 1, 64, 64, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("kernel,stride,padding,cin,cout,n", K3_EDGE_CASES)
def test_sparse_conv_dw_at_tile_edges(cuda, kernel, stride, padding, cin, cout, n, dtype):
    """K3 over a given map at the edges of its tiles: a Cin or Cout that is
    not a multiple of 8 (padded by the wrapper), Cout 256 (two channel
    tiles), fewer rows than one step; against its plain version with the
    same rounding, and bit for bit the same in a second run."""
    st = _sparse_case(cuda, cin, n=n, shape=(41, 160, 140) if n > 100 else (5, 8, 8))
    coords = st.coords if stride == 1 else TS.conv_output_sites(st, kernel, stride, padding,
                                                                 st.capacity)[1]
    nbr = cuda_conv.neighbor_map(st.keys, coords, st.spatial_shape, st.batch_size, kernel, stride,
                                 padding)
    g = torch.randn(coords.shape[0], cout, generator=torch.Generator().manual_seed(8)).to(cuda)
    args = (st.features.to(dtype), st.keys, coords, g, st.spatial_shape, st.batch_size, kernel,
            stride, padding)
    dw = cuda_conv.sparse_conv_dw(*args, nbr=nbr)
    again = cuda_conv.sparse_conv_dw(*args, nbr=nbr)
    torch.cuda.synchronize()
    ref = cuda_conv.sparse_conv_dw_plain(*args, nbr=nbr)
    assert dw.shape == ref.shape == (nbr.shape[0], cin, cout)
    scale = float(ref.abs().max())
    torch.testing.assert_close(dw, ref, rtol=1e-3, atol=1e-4 * scale)
    assert torch.equal(dw, again) and scale > 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_sparse_conv_dw_with_empty_and_full_taps(cuda, dtype):
    """K3 over a map with a tap that matches nothing (its dW is exactly 0)
    and a tap that matches every row, padding rows included."""
    st = _sparse_case(cuda, 16, n=5003)
    nbr = _map_with_empty_and_full_taps(st, st.coords, 3, 1, 1)
    g = torch.randn(st.capacity, 32, generator=torch.Generator().manual_seed(9)).to(cuda)
    args = (st.features.to(dtype), st.keys, st.coords, g, st.spatial_shape, st.batch_size, 3, 1, 1)
    dw = cuda_conv.sparse_conv_dw(*args, nbr=nbr)
    ref = cuda_conv.sparse_conv_dw_plain(*args, nbr=nbr)
    scale = float(ref.abs().max())
    torch.testing.assert_close(dw, ref, rtol=1e-3, atol=1e-4 * scale)
    assert torch.equal(dw[0], torch.zeros_like(dw[0])) and float(dw[1].abs().max()) > 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["max", "sum"])
def test_sparse_pools_over_a_given_map(cuda, mode):
    """K2 reads the map it is given (no search): with an emptied tap and a
    tap that matches every row, bit for bit its plain version over the same
    map, and one launch, no map build."""
    st = _sparse_case(cuda, 2, n=5003)
    feats = st.features.abs()
    _, coords, _, _ = TS.conv_output_sites(st, 3, 2, 1, st.capacity)
    nbr = _map_with_empty_and_full_taps(st, coords, 3, 2, 1)
    wrapper, plain = ((cuda_pool.sparse_pool, cuda_pool.sparse_pool_plain) if mode == "max"
                      else (cuda_pool.sparse_sum_pool, cuda_pool.sparse_sum_pool_plain))
    n0 = (cuda_conv.nbr_launches, cuda_pool.launches + cuda_pool.sum_launches)
    out = wrapper(feats, st.keys, coords, st.spatial_shape, st.batch_size, 3, 2, 1, nbr=nbr)
    torch.cuda.synchronize()
    assert (cuda_conv.nbr_launches, cuda_pool.launches + cuda_pool.sum_launches) == (
        n0[0], n0[1] + 1)
    ref = plain(feats, st.keys, coords, st.spatial_shape, 3, 2, 1, nbr)
    assert torch.equal(out, ref) and float(ref.max()) > 0
    with pytest.raises(ValueError):
        wrapper(feats, st.keys, coords, st.spatial_shape, st.batch_size, 3, 2, 1, nbr=nbr[:8])
