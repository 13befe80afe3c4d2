"""Sparse pooling forward: CUDA kernel K2 (`csrc/sparse_pool.cu`) in its max
and sum modes, and their plain PyTorch versions (counterpart of
`btcdet_tpu/ops/pallas_conv.py::fused_pool(mode="max" / "sum")` and of
their XLA twins `sparse.apply_rulebook_max` and the found-masked gather-sum).

Both compute, for output sites `out_coords` of a strided window over a
key-sorted input table,

    max: out[m, c] = max over the taps k matching an input row i of features[i, c]
    sum: out[m, c] = sum over the taps k matching an input row i of features[i, c]

with 0 for rows where no tap matches (padding rows b < 0 included), in
the features' float32. The matches come from the (K, M) neighbour map of
K1 (`cuda_conv.neighbor_map`): the pools of the det backbone read the map
that the trunk's strided conv built for the same input table, sites and
geometry (`sparse.neighbor_map_cached`). The sum adds the taps one at a
time in tap order, in the kernel and in the plain version alike.

`sparse_pool` (max) and `sparse_sum_pool` (sum) take the plain version for
CPU tensors only; a CUDA tensor launches the kernel or raises. K2 has no
backward: its input, the occ code, is stop-gradient
(OCC_PNT_UPDATE.PASS_GRAD False), so a CUDA input that requires a gradient
is refused.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_conv, kernel_build
from .cuda_conv import INT32_MAX, check_map, neighbor_map_plain, triple

# kernel launches made by the wrappers below, max and sum mode (CPU calls
# take the plain versions and are not counted)
launches = 0
sum_launches = 0


def sparse_pool_plain(features, in_keys, out_coords, in_spatial_shape, kernel_size, stride,
                      padding, nbr=None):
    """The plain PyTorch version of K2 max over the map `nbr` of these pairs
    (`cuda_conv.neighbor_map_plain`, built here when None): gather, then
    the max over the matched taps, 0 where none matched."""
    if nbr is None:
        nbr = neighbor_map_plain(in_keys, out_coords, in_spatial_shape, kernel_size, stride,
                                 padding)
    found = nbr >= 0
    g = features[nbr.clamp(min=0).long()]                              # (K, M, C)
    neg = torch.finfo(features.dtype).min
    g = torch.where(found[..., None], g, torch.full((), neg, dtype=g.dtype, device=g.device))
    out = g.amax(dim=0)
    return torch.where(found.any(dim=0)[:, None], out, torch.zeros((), dtype=out.dtype,
                                                                    device=out.device))


def sparse_sum_pool_plain(features, in_keys, out_coords, in_spatial_shape, kernel_size, stride,
                          padding, nbr=None):
    """The plain PyTorch version of K2 sum over the map `nbr` (built here
    when None): the matched rows added one tap at a time in tap order (the
    kernel's order)."""
    if nbr is None:
        nbr = neighbor_map_plain(in_keys, out_coords, in_spatial_shape, kernel_size, stride,
                                 padding)
    zero = torch.zeros((), dtype=features.dtype, device=features.device)
    out = torch.zeros((nbr.shape[1], features.shape[1]), dtype=features.dtype,
                      device=features.device)
    for k in range(nbr.shape[0]):
        out = out + torch.where(nbr[k, :, None] >= 0, features[nbr[k].clamp(min=0).long()], zero)
    return out


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_void_p]


def _fn(name: str):
    fn = getattr(kernel_build.load("sparse_pool"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _launch(who, entry, features, in_keys, out_coords, in_spatial_shape, batch_size,
            kernel_size, stride, padding, nbr):
    """Check the inputs and launch K2's `entry` on a CUDA tensor over the
    map `nbr` (built here when None); returns (out (M, C) float32,
    launched)."""
    if features.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {features.device}")
    if features.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(f"{who}: K2 has no backward; its input must not "
                                  "require a gradient")
    kz, ky, kx = triple(kernel_size)
    K = kz * ky * kx
    nz, ny, nx = (int(v) for v in in_spatial_shape)
    N, C = features.shape
    M = out_coords.shape[0]
    if features.dtype != torch.float32:
        raise TypeError(f"{who}: features must be float32, got {features.dtype}")
    if in_keys.dtype != torch.int32 or out_coords.dtype != torch.int32:
        raise TypeError(f"{who}: keys and coords must be int32")
    if K > 27 or out_coords.shape[1:] != (4,) or in_keys.shape != (N,):
        raise ValueError(f"{who}: bad shapes features {tuple(features.shape)} "
                         f"keys {tuple(in_keys.shape)} coords {tuple(out_coords.shape)}")
    if batch_size * nz * ny * nx >= INT32_MAX:
        raise ValueError(f"{who}: grid x batch overflows int32 keys")
    for t in (in_keys, out_coords):
        if t.device != features.device:
            raise ValueError(f"{who}: tensors on different devices")
    if nbr is None:
        nbr = cuda_conv.neighbor_map(in_keys, out_coords, in_spatial_shape, batch_size,
                                     kernel_size, stride, padding)
    check_map(who, nbr, K, M, features.device)
    features, nbr = features.contiguous(), nbr.contiguous()
    out = torch.empty((M, C), dtype=torch.float32, device=features.device)
    if M == 0:
        return out, False
    stream = torch.cuda.current_stream(features.device).cuda_stream
    err = _fn(entry)(features.data_ptr(), nbr.data_ptr(), M, K, out.data_ptr(), C, stream)
    if err != 0:
        raise RuntimeError(f"{who} kernel launch failed: cudaError {err}")
    return out, True


def sparse_pool(features, in_keys, out_coords, in_spatial_shape, batch_size, kernel_size,
                stride, padding, nbr=None):
    """(M, C) float32 sparse max-pool forward (K2 max).

    features (N, C) float32; in_keys (N,) int32 ascending, padding
    INT32_MAX; out_coords (M, 4) int32 (b, z, y, x), padding rows b < 0;
    nbr the (K, M) neighbour map of these pairs (`cuda_conv.neighbor_map`),
    built here when None.
    """
    if features.device.type == "cpu":
        return sparse_pool_plain(features, in_keys, out_coords, in_spatial_shape, kernel_size,
                                 stride, padding, nbr)
    out, launched = _launch("sparse_pool", "sparse_maxpool_fwd", features, in_keys, out_coords,
                            in_spatial_shape, batch_size, kernel_size, stride, padding, nbr)
    if launched:
        global launches
        launches += 1
    return out


def sparse_sum_pool(features, in_keys, out_coords, in_spatial_shape, batch_size, kernel_size,
                    stride, padding, nbr=None):
    """(M, C) float32 sparse sum-pool forward (K2 sum): the unweighted sum
    of the matched rows; inputs as `sparse_pool`."""
    if features.device.type == "cpu":
        return sparse_sum_pool_plain(features, in_keys, out_coords, in_spatial_shape,
                                     kernel_size, stride, padding, nbr)
    out, launched = _launch("sparse_sum_pool", "sparse_sumpool_fwd", features, in_keys,
                            out_coords, in_spatial_shape, batch_size, kernel_size, stride,
                            padding, nbr)
    if launched:
        global sum_launches
        sum_launches += 1
    return out
