"""ROI trilinear sampler parity: the plain version of kernel K4
(`btcdet_tpu_torch/ops/cuda_interp.py`) against the Pallas sampler it
replaces (interpret mode, bf16 tolerance) and its XLA twin
`pallas_interp._xla_reference_pool` (f32 tolerance). Samples outside the
Pallas kernel's 24x24-cell roi window are compared with the twin only:
the port keeps them, the TPU kernel drops them."""

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
    vol = torch.from_numpy(dense)
    if bf16_volume:
        vol = vol.to(torch.bfloat16)
    return cuda_interp.trilinear_pool(vol, torch.from_numpy(zyx), torch.from_numpy(roi_b),
                                      torch.from_numpy(valid)).numpy()


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
