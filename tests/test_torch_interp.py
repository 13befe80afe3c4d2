"""ROI trilinear sampler parity: the plain version of kernel K4
(`btcdet_tpu_torch/ops/cuda_interp.py`) against the Pallas sampler it
replaces (interpret mode, bf16 tolerance) and its XLA twin
`pallas_interp._xla_reference_pool` (f32 tolerance on an f32 volume that
holds the bf16-rounded values; one bf16 ulp for the bf16 output of a bf16
volume, which the sampler sums in f32 and rounds once). Samples outside the
Pallas kernel's 24x24-cell roi window are compared with the twin only:
the port keeps them, the TPU kernel drops them."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btcdet_tpu.ops import pallas_interp as PI
from btcdet_tpu.utils import common as jcommon
from btcdet_tpu_torch.ops import cuda_interp
from btcdet_tpu_torch.utils import common as tcommon
from torch_parity import assert_close


def make_case(seed=0, B=2, D=5, H=40, W=48, C=64, R=6, S=576, spread=14.0):
    rng = np.random.RandomState(seed)
    dense = rng.randn(B, D, H, W, C).astype(np.float32)
    roi_b = rng.randint(0, B, R).astype(np.int32)
    centers = np.stack([rng.rand(R) * (H - 10) + 5, rng.rand(R) * (W - 10) + 5],
                       -1).astype(np.float32)
    offs = (rng.rand(R, S, 2) - 0.5) * spread
    zyx = np.concatenate([rng.rand(R, S, 1) * (D + 2) - 1,      # z also leaves the volume
                          centers[:, None, :] + offs], axis=-1).astype(np.float32)
    valid = rng.rand(R, S) < 0.9
    return dense, zyx, centers, roi_b, valid


def _port(dense, zyx, roi_b, valid, bf16_volume=True):
    """The plain sampler in f32 on the volume, bf16-rounded first as the
    twin rounds it (`bf16_volume`)."""
    vol = torch.from_numpy(dense)
    if bf16_volume:
        vol = vol.to(torch.bfloat16).float()
    return cuda_interp.trilinear_pool(vol, torch.from_numpy(zyx), torch.from_numpy(roi_b),
                                      torch.from_numpy(valid)).numpy()


def bf16_ulp(x):
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    a = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(a)) - 7).astype(np.float32)


def _twin(dense, zyx, roi_b, valid):
    return np.asarray(PI._xla_reference_pool(jnp.asarray(dense), jnp.asarray(zyx),
                                             jnp.asarray(roi_b), jnp.asarray(valid)))


def test_plain_sampler_matches_xla_twin():
    dense, zyx, _, roi_b, valid = make_case()
    out = _port(dense, zyx, roi_b, valid)
    assert out.shape == zyx.shape[:2] + (dense.shape[-1],)
    assert_close(out, _twin(dense, zyx, roi_b, valid), rtol=1e-5, atol=1e-5)
    assert (out[~valid] == 0).all()


def test_plain_sampler_matches_pallas_kernel():
    dense, zyx, centers, roi_b, valid = make_case(seed=1)
    ref = PI.trilinear_pool(jnp.asarray(dense), jnp.asarray(zyx), jnp.asarray(centers),
                            jnp.asarray(roi_b), jnp.asarray(valid), tile=288, interpret=True)
    volp = PI.prep_volume(jnp.asarray(dense))
    assert int(PI.window_miss_count(jnp.asarray(zyx), jnp.asarray(centers), jnp.asarray(roi_b),
                                    jnp.asarray(valid), volp.shape[1], volp.shape[2])) == 0
    np.testing.assert_allclose(_port(dense, zyx, roi_b, valid), np.asarray(ref),
                               atol=3e-2, rtol=3e-2)


def test_samples_outside_the_tpu_window_are_kept():
    dense, zyx, centers, roi_b, valid = make_case(seed=2, H=96, W=96, spread=70.0)
    volp = PI.prep_volume(jnp.asarray(dense))
    miss = int(PI.window_miss_count(jnp.asarray(zyx), jnp.asarray(centers), jnp.asarray(roi_b),
                                    jnp.asarray(valid), volp.shape[1], volp.shape[2]))
    assert miss > 100, "the case must reach past the 24-cell window"
    assert_close(_port(dense, zyx, roi_b, valid), _twin(dense, zyx, roi_b, valid),
                 rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 3])
def test_trilinear_interpolate_dense_matches(seed):
    dense, zyx, _, _, _ = make_case(seed=seed, B=1, R=1, S=500)
    ref = jcommon.trilinear_interpolate_dense(jnp.asarray(dense[0]), jnp.asarray(zyx[0]))
    out = tcommon.trilinear_interpolate_dense(torch.from_numpy(dense[0]), torch.from_numpy(zyx[0]))
    assert_close(out.numpy(), np.asarray(ref))
    # the roi sampler with f32 volume and all samples valid is the same function
    full = _port(dense, zyx, np.zeros(1, np.int32), np.ones((1, 500), bool), bf16_volume=False)
    assert_close(full[0], np.asarray(ref))


def test_volume_gradient_matches_xla_twin():
    """`TrilinearPoolFunction`'s backward (the 8-corner scatter-add, points
    constant) against `jax.grad` of the XLA twin, whose bf16 volume cast
    rounds the gradient to bf16 too: bf16 tolerance."""
    import jax

    dense, zyx, _, roi_b, valid = make_case(seed=4, C=16)
    dense = torch.from_numpy(dense).to(torch.bfloat16).float().numpy()
    g = np.random.RandomState(5).randn(*zyx.shape[:2], 16).astype(np.float32)
    ref = jax.grad(lambda d: (PI._xla_reference_pool(
        d, jnp.asarray(zyx), jnp.asarray(roi_b), jnp.asarray(valid)) * jnp.asarray(g)).sum())(
        jnp.asarray(dense))
    vol = torch.from_numpy(dense).to(torch.bfloat16).requires_grad_()
    out = cuda_interp.TrilinearPoolFunction.apply(vol, torch.from_numpy(zyx),
                                                  torch.from_numpy(roi_b), torch.from_numpy(valid))
    (out * torch.from_numpy(g)).sum().backward()
    ref = np.asarray(ref)
    assert vol.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(vol.grad.float().numpy(), ref, rtol=1e-2,
                               atol=1e-2 * np.abs(ref).max())
    assert (ref != 0).mean() > 0.05


@pytest.mark.parametrize("hot", [True, False], ids=["hot", "spread"])
def test_ordered_volume_gradient_matches_xla_vjp(hot):
    """`trilinear_pool_volume_grad_ordered`, the order of the kernel
    `trilinear_pool_bwd` (each cell's entries ascending, Kahan in f32 in
    chunks of BWD_CHUNK entries, chunks added in order), against jax.vjp of
    the XLA twin. The twin casts its volume to bf16, so its VJP is the f32
    scatter-add rounded once to bf16: the ordered f32 sum rounded once is
    within one bf16 ulp of it, plus 1e-5 of the max where the two f32 sums
    differ by more than that ulp (near 0). Against a float64 sum the ordered
    version is no further off than the `index_add_` one. `hot` piles all
    rois around one centre: segments of several chunks."""
    import jax

    dense, zyx, centers, roi_b, valid = make_case(seed=9, C=16, R=12, spread=2.0 if hot else 14.0)
    if hot:
        zyx[..., 1:] += centers[:1, None] - centers[:, None]
    g = np.random.RandomState(10).randn(*zyx.shape[:2], 16).astype(np.float32)
    _, vjp = jax.vjp(lambda d: PI._xla_reference_pool(d, jnp.asarray(zyx), jnp.asarray(roi_b),
                                                      jnp.asarray(valid)), jnp.asarray(dense))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    args = (torch.from_numpy(g), dense.shape, torch.from_numpy(zyx), torch.from_numpy(roi_b),
            torch.from_numpy(valid))
    out = cuda_interp.trilinear_pool_volume_grad_ordered(*args)
    cells, _ = cuda_interp._corner_entries(*args[2:], dense.shape)
    longest = int(torch.bincount(cells[cells >= 0]).max())
    assert (longest > 4 * cuda_interp.BWD_CHUNK) == hot, longest
    got = out.to(torch.bfloat16).float().numpy()
    tol = np.maximum(bf16_ulp(got), bf16_ulp(ref)) + 1e-5 * np.abs(ref).max()
    assert (np.abs(got - ref) <= tol).all()
    assert (ref != 0).sum() > 1000
    exact = cuda_interp.trilinear_pool_volume_grad(*args, dtype=torch.float64)
    plain = cuda_interp.trilinear_pool_volume_grad(*args)
    assert float((out.double() - exact).abs().max()) <= float((plain.double() - exact)
                                                              .abs().max())


@pytest.mark.parametrize("layout", ["zyx", "yzx-permuted"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_sampler_on_strided_volumes(layout, dtype):
    """The sampler takes the volume as a strided view with a unit channel
    stride: the contiguous (B, D, H, W, C) volume, or the permuted view of
    the scatter-native (B, H, D, W, C) table that `SparseTensor.dense()`
    returns (what ConvHead passes). Both give the same samples, in the
    volume's dtype: the XLA twin's within 1e-5 in f32, within one bf16 ulp
    of the twin's f32 value in bf16."""
    dense, zyx, _, roi_b, valid = make_case(seed=6, C=16)
    # bf16-rounded values, as the twin rounds its volume
    dense = torch.from_numpy(dense).to(torch.bfloat16).to(dtype)
    if layout == "zyx":
        vol = dense
    else:
        vol = dense.permute(0, 2, 1, 3, 4).contiguous().permute(0, 2, 1, 3, 4)
        assert not vol.is_contiguous() and vol.stride(-1) == 1
    out = cuda_interp.trilinear_pool(vol, torch.from_numpy(zyx), torch.from_numpy(roi_b),
                                     torch.from_numpy(valid))
    assert out.dtype == dtype and out.shape == zyx.shape[:2] + (16,)
    ref = _twin(dense.float().numpy(), zyx, roi_b, valid)
    got = out.float().numpy()
    if dtype == torch.float32:
        assert_close(got, ref, rtol=1e-5, atol=1e-5)
    else:
        assert (np.abs(got - ref) <= bf16_ulp(ref)).all()
    assert (got[~valid] == 0).all() and np.abs(got).max() > 0.5
    flat = cuda_interp.trilinear_pool(dense, torch.from_numpy(zyx), torch.from_numpy(roi_b),
                                      torch.from_numpy(valid))
    assert torch.equal(out, flat)


def test_plain_sampler_on_a_sparse_tensor_dense_view():
    """ConvHead's volume: `SparseTensor.dense()` (a permuted view, no copy)
    of a bf16 table, sampled in bf16, against the twin on the JAX package's
    dense volume of the same table, within one bf16 ulp."""
    from btcdet_tpu.ops import sparse as JS
    from btcdet_tpu_torch.ops import sparse as TS

    rng = np.random.RandomState(7)
    B, D, H, W, C = 2, 5, 40, 48, 16
    coords = np.unique(np.stack([rng.randint(0, B, 3000), rng.randint(0, D, 3000),
                                 rng.randint(0, H, 3000), rng.randint(0, W, 3000)], 1), axis=0)
    coords = np.concatenate([coords, np.full((50, 4), -1)]).astype(np.int32)
    feats = torch.from_numpy(rng.randn(len(coords), C).astype(np.float32)).to(torch.bfloat16)
    st = TS.from_coords(feats, torch.from_numpy(coords), (D, H, W), B)
    vol = st.dense()
    assert vol.shape == (B, D, H, W, C) and not vol.is_contiguous()
    _, zyx, _, roi_b, valid = make_case(seed=8, B=B, D=D, H=H, W=W, C=C)
    out = cuda_interp.trilinear_pool(vol, torch.from_numpy(zyx), torch.from_numpy(roi_b),
                                     torch.from_numpy(valid))
    assert out.dtype == torch.bfloat16
    jst = JS.from_coords(jnp.asarray(feats.float().numpy()), jnp.asarray(coords), (D, H, W), B)
    ref = _twin(np.asarray(jst.dense()), zyx, roi_b, valid)
    got = out.float().numpy()
    assert (np.abs(got - ref) <= bf16_ulp(ref)).all()
    assert np.abs(ref).max() > 0.5


# ------------------------------------ ConvHead's x_combine pool, train mode

def _xc_case(n_rois: int, seed: int = 5):
    """ConvHead's `_x_combine_pool` in train mode on the micro widths (the
    micro config's CONV_GRID_POOL: 8 grid points a roi, a (2, 4, 12) local
    grid, 8 channels) over a random (5, 4, 4) x 16 volume, 2 frames of
    `n_rois` rois (a few invalid): the JAX package's CPU path (XLA sampler,
    the conv stack chunked over `roi_chunk` rois) from its init, and the
    port's head with the same weights. Returns (JAX output, JAX BN running
    statistics after the call, the port's head, its inputs)."""
    import flax.linen as nn
    import jax

    from btcdet_tpu.models.roi_heads import conv_head as JCH
    from btcdet_tpu.ops import sparse as JS
    from btcdet_tpu_torch.datasets import mini_config
    from btcdet_tpu_torch.models.roi_heads import conv_head as TCH
    from btcdet_tpu_torch.ops import sparse as TS

    cg = mini_config.micro_model_cfg().ROI_HEAD.CONV_GRID_POOL
    xc = cg.CONV_LAYER.x_combine
    pcr, dvs = (0.0, -3.2, -3.0, 6.4, 3.2, 1.1), (0.2, 0.2, 0.1)
    geom = dict(grid_size=tuple(cg.GRID_SIZE), point_cloud_range=pcr, det_voxel_size=dvs,
                xc_part_scene=tuple(xc.PART_SCENE_SIZE), xc_ker_size=tuple(xc.KER_SIZE),
                xc_kernels=tuple(map(tuple, xc.KERNEL)),
                xc_paddings=tuple(map(tuple, xc.PADDING)),
                xc_strides=tuple(map(tuple, xc.STRIDE)), xc_channels=tuple(xc.CHANNEL),
                xc_downsample=tuple(xc.DOWNSAMPLE_FACTOR))

    class XcPool(JCH.ConvHead):
        @nn.compact
        def __call__(self, rois, roi_valid, grid_pts, x_combine):
            return self._x_combine_pool(rois, roi_valid, grid_pts, x_combine, True)

    rng = np.random.RandomState(seed)
    B, shape, C = 2, (5, 4, 4), 16
    cells = np.stack(np.meshgrid(*map(np.arange, shape), indexing="ij"), -1).reshape(-1, 3)
    coords = np.concatenate([np.concatenate([np.full((len(cells), 1), b), cells], 1)
                             for b in range(B)]).astype(np.int32)
    coords[rng.rand(len(coords)) < 0.3] = -1           # inactive sites
    feats = rng.randn(len(coords), C).astype(np.float32)
    rois = np.concatenate([rng.uniform([1.0, -2.2, -2.0], [5.4, 2.2, 0.0], (B, n_rois, 3)),
                           rng.uniform([1.5, 0.6, 0.6], [4.0, 1.8, 1.8], (B, n_rois, 3)),
                           rng.uniform(-np.pi, np.pi, (B, n_rois, 1))], -1).astype(np.float32)
    roi_valid = rng.rand(B, n_rois) < 0.9
    grid_pts = np.array(JCH.global_roi_grid_points(jnp.asarray(rois), geom["grid_size"]))
    jhead = XcPool(num_class=1, compute_dtype=jnp.float32, **geom)
    jx = JS.from_coords(jnp.asarray(feats), jnp.asarray(coords), shape, B)
    args = (jnp.asarray(rois), jnp.asarray(roi_valid), jnp.asarray(grid_pts), jx)
    variables = jax.jit(jhead.init)(jax.random.PRNGKey(seed), *args)
    out, upd = jax.jit(lambda v, *a: jhead.apply(v, *a, mutable=["batch_stats"]))(
        variables, *args)
    head = TCH.ConvHead(1, C, features_source=("x_combine",), compute_dtype=torch.float32,
                        **geom).train()
    p, s = variables["params"], variables["batch_stats"]
    for i, blk in enumerate(head.conv_layers[0]):
        conv, bn = getattr(blk, "0"), getattr(blk, "1")
        conv.weight.data = torch.from_numpy(np.array(p[f"xc_conv_{i}"]["kernel"]))
        jbn, jst = p[f"xc_bn_{i}"]["MaskedBatchNorm_0"], s[f"xc_bn_{i}"]["MaskedBatchNorm_0"]
        bn.weight.data, bn.bias.data = (torch.from_numpy(np.array(jbn[k]))
                                        for k in ("scale", "bias"))
        bn.running_mean.data, bn.running_var.data = (torch.from_numpy(np.array(jst[k]))
                                                     for k in ("mean", "var"))
    tx = TS.from_coords(torch.from_numpy(feats), torch.from_numpy(coords), shape, B)
    targs = (torch.from_numpy(rois), torch.from_numpy(roi_valid), torch.from_numpy(grid_pts), tx)
    stats = [{k: np.asarray(upd["batch_stats"][f"xc_bn_{i}"]["MaskedBatchNorm_0"][k])
              for k in ("mean", "var")} for i in range(len(head.conv_layers[0]))]
    return np.asarray(out), stats, head, targs


def _running_stats(head):
    return [{"mean": getattr(blk, "1").running_mean.numpy(),
             "var": getattr(blk, "1").running_var.numpy()} for blk in head.conv_layers[0]]


def test_x_combine_pool_matches_jax_cpu_path_up_to_32_rois():
    """24 rois a frame: the JAX CPU path runs the conv stack over all rois
    in one chunk (`roi_chunk` 32), as the port always does; the pooled
    features and the BN running statistics agree to 1e-4."""
    ref, stats, head, args = _xc_case(24)
    with torch.no_grad():
        out = head._x_combine_pool(*args).numpy()
    assert out.shape == ref.shape and np.abs(ref).max() > 0.1
    assert_close(out, ref, rtol=1e-4, atol=1e-4)
    for got, want in zip(_running_stats(head), stats):
        for k in want:
            assert_close(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)


def test_x_combine_pool_parts_from_jax_cpu_path_past_32_rois():
    """40 rois a frame: the JAX CPU path takes the conv stack's train-time BN
    statistics per chunk of 32 rois (both frames' rois 0-31, then 32-39),
    the port (and the JAX TPU path) over all rois. The pooled features part
    by far more than rounding; the port run chunk by chunk, its running
    statistics moved once a chunk, equals the JAX CPU path to 1e-4."""
    ref, stats, head, args = _xc_case(40)
    whole_head = copy.deepcopy(head)
    with torch.no_grad():
        whole = whole_head._x_combine_pool(*args).numpy()
        rois, valid, grid_pts, x = args
        G = grid_pts.shape[2]
        chunked = np.concatenate([head._x_combine_pool(rois[:, a:a + 32], valid[:, a:a + 32],
                                                       grid_pts[:, a:a + 32], x).numpy()
                                  for a in (0, 32)], axis=1)
    assert_close(chunked, ref, rtol=1e-4, atol=1e-4)
    for got, want in zip(_running_stats(head), stats):
        for k in want:
            assert_close(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)
    part = np.abs(whole - ref).max()
    assert part > 1e-2 * np.abs(ref).max(), part
    # the first chunk's rois part too: their statistics lack rois 32-39
    assert np.abs(whole[:, :32 * G] - ref[:, :32 * G]).max() > 1e-3, part
