"""The port's CUDA kernels against their plain PyTorch versions on the
card: K1 (`ops/cuda_conv.sparse_conv`, and `sparse_conv_df` in
transpose-query mode), K3 (`ops/cuda_conv.sparse_conv_dw`), K2 max and sum
(`ops/cuda_pool.sparse_pool` / `sparse_sum_pool`) and K4
(`ops/cuda_interp.trilinear_pool`). Tests marked `cuda` skip where no
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
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


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


@pytest.mark.cuda
def test_sparse_sum_pool_refuses_a_gradient(cuda):
    """K2 sum has no backward: a CUDA input that requires a gradient is refused."""
    st = _sparse_case(cuda, 2, n=500)
    _, coords, _, _ = TS.conv_output_sites(st, 3, 2, 1, st.capacity)
    feats = st.features.clone().requires_grad_()
    with pytest.raises(NotImplementedError):
        cuda_pool.sparse_sum_pool(feats, st.keys, coords, st.spatial_shape, 2, 3, 2, 1)
    with torch.no_grad():
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
def test_sparse_pool_refuses_a_gradient(cuda):
    """K2 has no backward: a CUDA input that requires a gradient is refused."""
    st = _sparse_case(cuda, 2, n=500)
    _, coords, _, _ = TS.conv_output_sites(st, 3, 2, 1, st.capacity)
    feats = st.features.clone().requires_grad_()
    with pytest.raises(NotImplementedError):
        cuda_pool.sparse_pool(feats, st.keys, coords, st.spatial_shape, 2, 3, 2, 1)
    with torch.no_grad():
        cuda_pool.sparse_pool(feats, st.keys, coords, st.spatial_shape, 2, 3, 2, 1)
