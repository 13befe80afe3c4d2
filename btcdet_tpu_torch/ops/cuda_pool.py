"""Sparse pooling forward: CUDA kernel K2 (`csrc/sparse_pool.cu`) in its max
and sum modes, and their plain PyTorch versions (counterpart of
`btcdet_tpu/ops/pallas_conv.py::fused_pool(mode="max" / "sum")` and of
their XLA twins `sparse.apply_rulebook_max` and the found-masked gather-sum).

Both compute, for output sites `out_coords` of a strided window over a
key-sorted input table,

    max: out[m, c] = max over the taps k matching an input row i of features[i, c]
    sum: out[m, c] = sum over the taps k matching an input row i of features[i, c]

with 0 for rows where no tap matches (padding rows b < 0 included), in
the features' float32. The sum adds the taps one at a time in tap order,
in the kernel and in the plain version alike.

`sparse_pool` (max) and `sparse_sum_pool` (sum) take the plain version for
CPU tensors only; a CUDA tensor launches the kernel or raises. K2 has no
backward: its input, the occ code, is stop-gradient
(OCC_PNT_UPDATE.PASS_GRAD False), so a CUDA input that requires a gradient
is refused.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernel_build
from .cuda_conv import INT32_MAX, conv_rulebook, triple

# kernel launches made by the wrappers below, max and sum mode (CPU calls
# take the plain versions and are not counted)
launches = 0
sum_launches = 0


def sparse_pool_plain(features, in_keys, out_coords, in_spatial_shape, kernel_size, stride,
                      padding):
    """The plain PyTorch version of K2 max: rulebook + gather + max over the
    matched taps."""
    idx, found = conv_rulebook(in_keys, out_coords, in_spatial_shape, kernel_size, stride,
                               padding)
    g = features[idx]                                                  # (K, M, C)
    neg = torch.finfo(features.dtype).min
    g = torch.where(found[..., None], g, torch.full((), neg, dtype=g.dtype, device=g.device))
    out = g.amax(dim=0)
    return torch.where(found.any(dim=0)[:, None], out, torch.zeros((), dtype=out.dtype,
                                                                    device=out.device))


def sparse_sum_pool_plain(features, in_keys, out_coords, in_spatial_shape, kernel_size, stride,
                          padding):
    """The plain PyTorch version of K2 sum: rulebook + gather, then the
    matched taps added one at a time in tap order (the kernel's order)."""
    idx, found = conv_rulebook(in_keys, out_coords, in_spatial_shape, kernel_size, stride,
                               padding)
    zero = torch.zeros((), dtype=features.dtype, device=features.device)
    out = torch.zeros((out_coords.shape[0], features.shape[1]), dtype=features.dtype,
                      device=features.device)
    for k in range(idx.shape[0]):
        out = out + torch.where(found[k, :, None], features[idx[k]], zero)
    return out


_ARGTYPES = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_int] + [ctypes.c_int] * 12 + [ctypes.c_void_p])


def _fn(name: str):
    fn = getattr(kernel_build.load("sparse_pool"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _launch(who, entry, features, in_keys, out_coords, in_spatial_shape, batch_size,
            kernel_size, stride, padding):
    """Check the inputs and launch K2's `entry` on a CUDA tensor; returns
    (out (M, C) float32, launched)."""
    if features.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {features.device}")
    if features.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(f"{who}: K2 has no backward; its input must not "
                                  "require a gradient")
    kz, ky, kx = triple(kernel_size)
    sz, sy, sx = triple(stride)
    pz, py, px = triple(padding)
    nz, ny, nx = (int(v) for v in in_spatial_shape)
    N, C = features.shape
    M = out_coords.shape[0]
    if features.dtype != torch.float32:
        raise TypeError(f"{who}: features must be float32, got {features.dtype}")
    if in_keys.dtype != torch.int32 or out_coords.dtype != torch.int32:
        raise TypeError(f"{who}: keys and coords must be int32")
    if kz * ky * kx > 27 or out_coords.shape[1:] != (4,) or in_keys.shape != (N,):
        raise ValueError(f"{who}: bad shapes features {tuple(features.shape)} "
                         f"keys {tuple(in_keys.shape)} coords {tuple(out_coords.shape)}")
    if batch_size * nz * ny * nx >= INT32_MAX:
        raise ValueError(f"{who}: grid x batch overflows int32 keys")
    for t in (in_keys, out_coords):
        if t.device != features.device:
            raise ValueError(f"{who}: tensors on different devices")
    features, in_keys, out_coords = (features.contiguous(), in_keys.contiguous(),
                                     out_coords.contiguous())
    out = torch.empty((M, C), dtype=torch.float32, device=features.device)
    if M == 0:
        return out, False
    stream = torch.cuda.current_stream(features.device).cuda_stream
    err = _fn(entry)(features.data_ptr(), in_keys.data_ptr(), N, out_coords.data_ptr(), M,
                     out.data_ptr(), C, kz, ky, kx, sz, sy, sx, pz, py, px, nz, ny, nx, stream)
    if err != 0:
        raise RuntimeError(f"{who} kernel launch failed: cudaError {err}")
    return out, True


def sparse_pool(features, in_keys, out_coords, in_spatial_shape, batch_size, kernel_size,
                stride, padding):
    """(M, C) float32 sparse max-pool forward (K2 max).

    features (N, C) float32; in_keys (N,) int32 ascending, padding
    INT32_MAX; out_coords (M, 4) int32 (b, z, y, x), padding rows b < 0.
    """
    if features.device.type == "cpu":
        return sparse_pool_plain(features, in_keys, out_coords, in_spatial_shape, kernel_size,
                                 stride, padding)
    out, launched = _launch("sparse_pool", "sparse_maxpool_fwd", features, in_keys, out_coords,
                            in_spatial_shape, batch_size, kernel_size, stride, padding)
    if launched:
        global launches
        launches += 1
    return out


def sparse_sum_pool(features, in_keys, out_coords, in_spatial_shape, batch_size, kernel_size,
                    stride, padding):
    """(M, C) float32 sparse sum-pool forward (K2 sum): the unweighted sum
    of the matched rows; inputs as `sparse_pool`."""
    if features.device.type == "cpu":
        return sparse_sum_pool_plain(features, in_keys, out_coords, in_spatial_shape,
                                     kernel_size, stride, padding)
    out, launched = _launch("sparse_sum_pool", "sparse_sumpool_fwd", features, in_keys,
                            out_coords, in_spatial_shape, batch_size, kernel_size, stride,
                            padding)
    if launched:
        global sum_launches
        sum_launches += 1
    return out
