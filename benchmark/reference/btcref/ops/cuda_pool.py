"""Sparse pools of the reference: the plain PyTorch versions of the
port's pool kernel K2 (max and sum over a neighbour map), frozen with
the benchmark. Every entry point runs the plain
version on any device."""

from __future__ import annotations

import torch

from .cuda_conv import neighbor_map_plain


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


def sparse_pool(features, in_keys, out_coords, in_spatial_shape, batch_size, kernel_size,
                stride, padding, nbr=None):
    return sparse_pool_plain(features, in_keys, out_coords, in_spatial_shape, kernel_size,
                             stride, padding, nbr=nbr)


def sparse_sum_pool(features, in_keys, out_coords, in_spatial_shape, batch_size, kernel_size,
                    stride, padding, nbr=None):
    return sparse_sum_pool_plain(features, in_keys, out_coords, in_spatial_shape, kernel_size,
                                 stride, padding, nbr=nbr)
