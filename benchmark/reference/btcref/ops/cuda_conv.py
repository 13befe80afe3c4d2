"""Sparse conv of the reference: the plain PyTorch versions of the
port's sparse-conv kernels (the neighbour map and the gather-GEMM K1),
frozen with the benchmark. Every entry point runs
the plain version on any device, in float32.

    out[m] = sum_k features[match(q(m, k))] @ weights[k]

with q(m, k) the y-major key of the input site out*stride - pad + tap_k
(taps in the canonical (dz, dy, dx) order of the weights), 0 for taps
with no active input, and 0 for padding rows (b < 0).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch


INT32_MAX = 2**31 - 1


def triple(v) -> tuple[int, int, int]:
    if isinstance(v, (int, np.integer)):
        return (int(v), int(v), int(v))
    assert len(v) == 3
    return tuple(int(x) for x in v)


def kernel_offsets(kernel_size) -> np.ndarray:
    """All (dz, dy, dx) taps, row-major: the weights' tap order."""
    kz, ky, kx = triple(kernel_size)
    return np.array(list(itertools.product(range(kz), range(ky), range(kx))), np.int64)


def query_keys(out_coords, in_spatial_shape, kernel_size, stride, padding,
               transpose: bool = False):
    """(K, M) int64 y-major input keys of every tap of every output row;
    -1 where the tap's site is off the input grid or the row is padding.
    `transpose`: the transpose query (c + pad - tap) / stride, kept where
    every component divides exactly (`pallas_conv.qkeys_conv(transpose=True)`)."""
    s = torch.tensor(triple(stride), dtype=torch.int64, device=out_coords.device)
    p = torch.tensor(triple(padding), dtype=torch.int64, device=out_coords.device)
    offs = torch.from_numpy(kernel_offsets(kernel_size)).to(out_coords.device)
    shape = torch.tensor(in_spatial_shape, dtype=torch.int64, device=out_coords.device)
    oc = out_coords.long()
    if transpose:
        num = oc[None, :, 1:4] + p - offs[:, None, :]
        divok = ((num >= 0) & (num % s == 0)).all(-1)
        in_zyx = torch.div(num, s, rounding_mode="floor")
    else:
        divok = True
        in_zyx = oc[None, :, 1:4] * s - p + offs[:, None, :]      # (K, M, 3)
    inb = ((in_zyx >= 0) & (in_zyx < shape)).all(-1) & (oc[None, :, 0] >= 0) & divok
    nz, ny, nx = in_spatial_shape
    key = ((oc[None, :, 0] * ny + in_zyx[..., 1]) * nz + in_zyx[..., 0]) * nx + in_zyx[..., 2]
    return torch.where(inb, key, torch.full_like(key, -1))


def lookup(table_keys, queries):
    """Binary search of query keys (any shape) in the sorted key table
    (N,) (counterpart of the JAX engine's `sparse.lookup`): returns (idx,
    found) shaped like `queries`; negative and INT32_MAX queries never
    match, and idx is 0 where nothing matched."""
    table = table_keys.long()
    flat = queries.reshape(-1).long()
    if table.numel() == 0:
        z = torch.zeros_like(flat)
        return z.reshape(queries.shape), (z != 0).reshape(queries.shape)
    idx = torch.searchsorted(table, flat).clamp(max=table.numel() - 1)
    found = (table[idx] == flat) & (flat >= 0) & (flat != INT32_MAX)
    idx = torch.where(found, idx, torch.zeros_like(idx))
    return idx.reshape(queries.shape), found.reshape(queries.shape)


def conv_rulebook(in_keys, out_coords, in_spatial_shape, kernel_size, stride, padding,
                  transpose: bool = False):
    """(idx, found), both (K, M): the input row of every tap of every output row."""
    return lookup(in_keys, query_keys(out_coords, in_spatial_shape, kernel_size, stride,
                                      padding, transpose))


def apply_rulebook_matmul(features, idx, found, weights):
    """sum_k where(found[k], features[idx[k]], 0) @ weights[k], in f32."""
    g = features.float()[idx]                                      # (K, M, Cin)
    g = torch.where(found[..., None], g, torch.zeros((), dtype=g.dtype, device=g.device))
    return torch.bmm(g, weights.float()).sum(0)


def neighbor_map_plain(in_keys, out_coords, in_spatial_shape, kernel_size, stride, padding,
                       transpose: bool = False):
    """The plain version of the map kernel: (K, M) int32, the input row of
    tap k of output row m (`conv_rulebook`), -1 where nothing matched."""
    idx, found = conv_rulebook(in_keys, out_coords, in_spatial_shape, kernel_size, stride,
                               padding, transpose)
    return torch.where(found, idx, torch.full_like(idx, -1)).to(torch.int32)


def apply_map_matmul(features, nbr, weights):
    """The plain gather-GEMM over a neighbour map (`apply_rulebook_matmul`)."""
    return apply_rulebook_matmul(features, nbr.clamp(min=0).long(), nbr >= 0, weights)


def neighbor_map(in_keys, out_coords, in_spatial_shape, batch_size, kernel_size, stride,
                 padding, transpose: bool = False):
    """(K, M) int32 neighbour map: `neighbor_map_plain`."""
    return neighbor_map_plain(in_keys, out_coords, in_spatial_shape, kernel_size, stride,
                              padding, transpose)


def sparse_conv(features, in_keys, out_coords, weights, in_spatial_shape, batch_size,
                kernel_size, stride, padding, nbr=None):
    """(M, Cout) float32 sparse-conv forward over the map `nbr` (built here
    when None)."""
    if nbr is None:
        nbr = neighbor_map(in_keys, out_coords, in_spatial_shape, batch_size, kernel_size,
                           stride, padding)
    return apply_map_matmul(features, nbr, weights)
