"""Sparse pooling: CUDA kernel K2 (`csrc/sparse_pool.cu`) in its max and sum
modes, their backward, and the plain PyTorch versions (counterpart of
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

The backward (the occ code carries a gradient under
OCC_PNT_UPDATE.PASS_GRAD) is the VJP of the JAX package's XLA twins,
`_pallas_pool_ad_bwd`: `sparse_pool_grad` gives each matched input the
output's gradient where its value equals the output's max, split evenly
over the tied taps; `sparse_sum_pool_grad` sums the gradient of every
output that reads the input. Both gather over the transpose-query map of
the same geometry (`cuda_conv.neighbor_map(..., transpose=True)`), in tap
order, so kernel and plain version agree bit for bit.
`sparse.SparsePoolFunction` wires them into autograd.

Each wrapper takes the plain version for CPU tensors only; a CUDA tensor
launches the kernel or raises. A CUDA input of the forward wrappers that
requires a gradient is refused: the gradient goes through
`sparse.SparsePoolFunction`, never around it.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_conv, kernel_build
from .cuda_conv import INT32_MAX, check_map, neighbor_map_plain, triple

# kernel launches made by the wrappers below, max and sum mode, forward and
# backward (CPU calls take the plain versions and are not counted)
launches = 0
sum_launches = 0
bwd_launches = 0
sum_bwd_launches = 0


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
    return _sum_over_map(features, nbr)


def _sum_over_map(features, nbr):
    """out[m] = the sum of features[nbr[k, m]] over the taps k with a
    match, added one tap at a time in tap order."""
    zero = torch.zeros((), dtype=features.dtype, device=features.device)
    out = torch.zeros((nbr.shape[1], features.shape[1]), dtype=features.dtype,
                      device=features.device)
    for k in range(nbr.shape[0]):
        out = out + torch.where(nbr[k, :, None] >= 0, features[nbr[k].clamp(min=0).long()], zero)
    return out


def sparse_pool_grad_plain(features, out, g, nbr, tnbr):
    """The plain PyTorch version of K2 max's backward: (N, C) f32 df, each
    input row adding, in tap order over the transpose-query map `tnbr`
    (K, N), g[m] / count[m] of every output row m that reads it where its
    value equals out[m]; count[m, c] is the number of matched taps of row
    m (forward map `nbr` (K, M)) whose value equals out[m, c]."""
    found = nbr >= 0
    tied = found[..., None] & (features[nbr.clamp(min=0).long()] == out[None])   # (K, M, C)
    share = g / tied.sum(0).clamp(min=1).to(g.dtype)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    df = torch.zeros(features.shape, dtype=g.dtype, device=g.device)
    for k in range(tnbr.shape[0]):
        m = tnbr[k].clamp(min=0).long()
        hit = (tnbr[k, :, None] >= 0) & (features == out[m])
        df = df + torch.where(hit, share[m], zero)
    return df


def sparse_sum_pool_grad_plain(g, tnbr):
    """The plain PyTorch version of K2 sum's backward: (N, C) df[i] = the
    sum of g[tnbr[k, i]] over the taps with a match, in tap order (K2 sum's
    forward with g as the table, over the transpose-query map)."""
    return _sum_over_map(g, tnbr)


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
        raise ValueError(f"{who}: an input that requires a gradient goes through "
                         "sparse.SparsePoolFunction")
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


def _check_grad(who, tensors, nbr, tnbr):
    """Raise unless the backward's float32 tensors and both maps sit on one
    CUDA device with matching shapes; returns (N, M, C, K)."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{who}: unsupported device {dev}")
    for t in tensors:
        if t.dtype != torch.float32 or t.dim() != 2 or t.device != dev:
            raise TypeError(f"{who}: expected 2-D float32 tensors on {dev}, got {t.dtype} "
                            f"{tuple(t.shape)} on {t.device}")
    K, N = tnbr.shape
    M, C = tensors[-1].shape
    check_map(who, tnbr, K, N, dev)
    if nbr is not None:
        check_map(who, nbr, K, M, dev)
    if K > 27 or any(t.shape[1] != C for t in tensors):
        raise ValueError(f"{who}: bad shapes {[tuple(t.shape) for t in tensors]} for {K} taps")
    return N, M, C, K


def sparse_pool_grad(features, out, g, nbr, tnbr):
    """(N, C) float32 df of K2 max: `sparse_pool_grad_plain`'s function.

    features (N, C) and out (M, C), the forward's input and output, and g
    (M, C), all float32; nbr the forward's (K, M) map; tnbr (K, N) the
    transpose-query map of the same geometry (`cuda_conv.neighbor_map(out
    keys, input coords, out shape, ..., transpose=True)`)."""
    if features.device.type == "cpu":
        return sparse_pool_grad_plain(features, out, g, nbr, tnbr)
    N, M, C, K = _check_grad("sparse_pool_grad", (features, out, g), nbr, tnbr)
    if features.shape[0] != N:
        raise ValueError(f"sparse_pool_grad: features {tuple(features.shape)} for a map of "
                         f"{N} input rows")
    features, out, g = features.contiguous(), out.contiguous(), g.contiguous()
    nbr, tnbr = nbr.contiguous(), tnbr.contiguous()
    df = torch.empty((N, C), dtype=torch.float32, device=features.device)
    if N == 0:
        return df
    stream = torch.cuda.current_stream(features.device).cuda_stream
    fn = getattr(kernel_build.load("sparse_pool"), "sparse_maxpool_bwd")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_int,
                                                                     ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(features.data_ptr(), out.data_ptr(), g.data_ptr(), nbr.data_ptr(), tnbr.data_ptr(),
             N, M, K, df.data_ptr(), C, stream)
    if err != 0:
        raise RuntimeError(f"sparse_pool_grad kernel launch failed: cudaError {err}")
    global bwd_launches
    bwd_launches += 1
    return df


def sparse_sum_pool_grad(g, tnbr):
    """(N, C) float32 df of K2 sum: K2 sum's forward kernel with g (M, C)
    float32 as the table, over the transpose-query map tnbr (K, N)."""
    if g.device.type == "cpu":
        return sparse_sum_pool_grad_plain(g, tnbr)
    N, M, C, K = _check_grad("sparse_sum_pool_grad", (g,), None, tnbr)
    g, tnbr = g.contiguous(), tnbr.contiguous()
    df = torch.empty((N, C), dtype=torch.float32, device=g.device)
    if N == 0:
        return df
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = _fn("sparse_sumpool_fwd")(g.data_ptr(), tnbr.data_ptr(), N, K, df.data_ptr(), C, stream)
    if err != 0:
        raise RuntimeError(f"sparse_sum_pool_grad kernel launch failed: cudaError {err}")
    global sum_bwd_launches
    sum_bwd_launches += 1
    return df
