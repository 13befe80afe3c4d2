"""Sparse max-pool forward: CUDA kernel K2, max mode
(`csrc/sparse_pool.cu`), and its plain PyTorch version (counterpart of
`btcdet_tpu/ops/pallas_conv.py::fused_pool(mode="max")` and of its XLA twin
`sparse.apply_rulebook_max`).

Both compute, for output sites `out_coords` of a strided window over a
key-sorted input table,

    out[m, c] = max over the taps k matching an input row i of features[i, c]

with 0 for rows where no tap matches (padding rows b < 0 included), in
the features' float32.

`sparse_pool` takes the plain version for CPU tensors only; a CUDA tensor
launches the kernel or raises. K2 has no backward: on the flagship its
input, the occ code, is stop-gradient (OCC_PNT_UPDATE.PASS_GRAD False), so
a CUDA input that requires a gradient is refused.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernel_build
from .cuda_conv import INT32_MAX, conv_rulebook, triple

# kernel launches made by the wrapper below (CPU calls take the plain
# version and are not counted)
launches = 0


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


_ARGTYPES = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_int] + [ctypes.c_int] * 12 + [ctypes.c_void_p])


def _lib():
    lib = kernel_build.load("sparse_pool")
    if lib.sparse_maxpool_fwd.argtypes is None:
        lib.sparse_maxpool_fwd.argtypes = _ARGTYPES
        lib.sparse_maxpool_fwd.restype = ctypes.c_int
    return lib


def sparse_pool(features, in_keys, out_coords, in_spatial_shape, batch_size, kernel_size,
                stride, padding):
    """(M, C) float32 sparse max-pool forward.

    features (N, C) float32; in_keys (N,) int32 ascending, padding
    INT32_MAX; out_coords (M, 4) int32 (b, z, y, x), padding rows b < 0.
    """
    if features.device.type == "cpu":
        return sparse_pool_plain(features, in_keys, out_coords, in_spatial_shape, kernel_size,
                                 stride, padding)
    if features.device.type != "cuda":
        raise ValueError(f"sparse_pool: unsupported device {features.device}")
    if features.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError("sparse_pool: K2 has no backward; its input must not "
                                  "require a gradient")
    kz, ky, kx = triple(kernel_size)
    sz, sy, sx = triple(stride)
    pz, py, px = triple(padding)
    nz, ny, nx = (int(v) for v in in_spatial_shape)
    N, C = features.shape
    M = out_coords.shape[0]
    if features.dtype != torch.float32:
        raise TypeError(f"sparse_pool: features must be float32, got {features.dtype}")
    if in_keys.dtype != torch.int32 or out_coords.dtype != torch.int32:
        raise TypeError("sparse_pool: keys and coords must be int32")
    if kz * ky * kx > 27 or out_coords.shape[1:] != (4,) or in_keys.shape != (N,):
        raise ValueError(f"sparse_pool: bad shapes features {tuple(features.shape)} "
                         f"keys {tuple(in_keys.shape)} coords {tuple(out_coords.shape)}")
    if batch_size * nz * ny * nx >= INT32_MAX:
        raise ValueError("sparse_pool: grid x batch overflows int32 keys")
    for t in (in_keys, out_coords):
        if t.device != features.device:
            raise ValueError("sparse_pool: tensors on different devices")
    features, in_keys, out_coords = (features.contiguous(), in_keys.contiguous(),
                                     out_coords.contiguous())
    out = torch.empty((M, C), dtype=torch.float32, device=features.device)
    if M == 0:
        return out
    stream = torch.cuda.current_stream(features.device).cuda_stream
    err = _lib().sparse_maxpool_fwd(
        features.data_ptr(), in_keys.data_ptr(), N, out_coords.data_ptr(), M, out.data_ptr(),
        C, kz, ky, kx, sz, sy, sx, pz, py, px, nz, ny, nx, stream)
    if err != 0:
        raise RuntimeError(f"sparse_pool kernel launch failed: cudaError {err}")
    global launches
    launches += 1
    return out
