"""Sparse 3D convolution engine (counterpart of `btcdet_tpu/ops/sparse.py`).

Active voxels live in capacity-padded tables sorted by a Y-MAJOR linear
key (b, y, z, x); padding rows carry key INT32_MAX and coords -1, so valid
rows come first. Strided convs generate their output sites by candidate
expansion + sorted unique under a static per-frame capacity, with the
same drop rule as the JAX engine when a capacity binds. The conv itself
runs through `cuda_conv.sparse_conv` (kernel K1 on CUDA tensors, the
rulebook + batched-matmul plain version on CPU tensors) over a neighbour
map built once per forward for each (input table, output sites,
geometry) (`neighbor_map_cached`), with its
backward through K1 (df) and K3 (dW, over the forward's map), the max-pool
and the fixed-weight sum-pool through `cuda_pool.sparse_pool` /
`sparse_sum_pool` (kernel K2, forward only, over the same cached maps).

`indice_key` semantics follow spconv: layers sharing a key reuse the
cached output-site set, and a layer whose kernel equals that of the conv
that made the set also reuses its stride and padding (`shared_sites`).
Conventions: coords (b, z, y, x) int32; features channels-last (N, C).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from ..parallel import all_reduce_sum
from ..utils.common import activation_dtype
from . import cuda_conv, cuda_pool
from .cuda_conv import INT32_MAX, triple


@dataclasses.dataclass
class SparseTensor:
    features: torch.Tensor     # (N, C)
    coords: torch.Tensor       # (N, 4) int32, -1 padding
    keys: torch.Tensor         # (N,) int32 ascending, INT32_MAX padding
    nnz: torch.Tensor          # () int64 live row count
    spatial_shape: tuple       # (nz, ny, nx)
    batch_size: int

    @property
    def capacity(self) -> int:
        return self.features.shape[0]

    @property
    def valid(self) -> torch.Tensor:
        return self.keys != INT32_MAX

    def replace(self, **kw) -> "SparseTensor":
        return dataclasses.replace(self, **kw)

    def dense(self, layout: str = "zyx") -> torch.Tensor:
        """(B, nz, ny, nx, C) channels-last ("zyx"), or the scatter-native
        (B, ny, nz, nx, C) ("yzx")."""
        nz, ny, nx = self.spatial_shape
        C = self.features.shape[-1]
        total = self.batch_size * nz * ny * nx
        out = torch.zeros((total + 1, C), dtype=self.features.dtype, device=self.features.device)
        valid = self.valid
        idx = torch.where(valid, self.keys.long(), torch.full_like(self.keys, total, dtype=torch.int64))
        out[idx] = torch.where(valid[:, None], self.features, torch.zeros_like(self.features))
        native = out[:-1].reshape(self.batch_size, ny, nz, nx, C)
        if layout == "yzx":
            return native
        return native.permute(0, 2, 1, 3, 4)


def linear_key(coords: torch.Tensor, spatial_shape, batch_size: int) -> torch.Tensor:
    """(N, 4) (b, z, y, x) -> int32 Y-MAJOR key (b, y, z, x); rows with
    b < 0 -> INT32_MAX."""
    nz, ny, nx = spatial_shape
    assert batch_size * nz * ny * nx < INT32_MAX, (
        f"grid {spatial_shape} x batch {batch_size} overflows int32 keys")
    c = coords.long()
    key = ((c[:, 0] * ny + c[:, 2]) * nz + c[:, 1]) * nx + c[:, 3]
    return torch.where(c[:, 0] >= 0, key, torch.full_like(key, INT32_MAX)).to(torch.int32)


def key_to_coords(keys: torch.Tensor, spatial_shape) -> torch.Tensor:
    nz, ny, nx = spatial_shape
    k = keys.long()
    b = k // (ny * nz * nx)
    r = k - b * (ny * nz * nx)
    y = r // (nz * nx)
    r = r - y * (nz * nx)
    z = r // nx
    x = r - z * nx
    coords = torch.stack([b, z, y, x], dim=-1).to(torch.int32)
    return torch.where((keys == INT32_MAX)[:, None], torch.full_like(coords, -1), coords)


def from_coords(features, coords, spatial_shape, batch_size: int, aux=None):
    """SparseTensor from (features, coords) with rows sorted by key; rows
    with b < 0 are padding. `aux` (a per-row side table) rides the same
    permutation and is returned as a second value."""
    spatial_shape = tuple(int(s) for s in spatial_shape)
    coords = coords.to(torch.int32)
    keys = linear_key(coords, spatial_shape, batch_size)
    order = torch.argsort(keys, stable=True)
    keys, coords, features = keys[order], coords[order], features[order]
    st = SparseTensor(features, coords, keys, (keys != INT32_MAX).sum(),
                      spatial_shape, int(batch_size))
    if aux is not None:
        return st, aux[order]
    return st


def conv_out_shape(spatial_shape, kernel_size, stride, padding):
    k, s, p = triple(kernel_size), triple(stride), triple(padding)
    return tuple((int(spatial_shape[i]) + 2 * p[i] - k[i]) // s[i] + 1 for i in range(3))


def _unique_capped(cand_keys, capacity: int, cells_per_batch: int, batch_size: int):
    """Sorted unique keys under a static capacity: (keys (capacity,)
    ascending with INT32_MAX padding, nnz). With batch_size > 1 each frame
    keeps at most capacity // batch_size of its smallest keys (the JAX
    engine's per-frame drop rule); otherwise the smallest `capacity`."""
    skey = torch.sort(cand_keys.long()).values
    first = torch.ones_like(skey, dtype=torch.bool)
    first[1:] = skey[1:] != skey[:-1]
    first &= skey != INT32_MAX
    rank = torch.cumsum(first.long(), 0) - 1
    if batch_size > 1:
        per_cap = capacity // batch_size
        bidx = (skey // cells_per_batch).clamp(0, batch_size - 1)
        bounds = torch.arange(batch_size, device=skey.device, dtype=torch.int64) * cells_per_batch
        pos = torch.searchsorted(skey, bounds, side="left")
        csum = rank + 1
        start = torch.where(pos > 0, csum[(pos - 1).clamp(min=0)], torch.zeros_like(pos))
        keep = first & ((rank - start[bidx]) < per_cap)
    else:
        keep = first & (rank < capacity)
    kept = skey[keep]
    out = torch.full((capacity,), INT32_MAX, dtype=torch.int64, device=skey.device)
    out[:kept.numel()] = kept
    return out.to(torch.int32), keep.sum()


def conv_output_sites(st: SparseTensor, kernel_size, stride, padding, out_capacity: int):
    """Output site set of a strided sparse conv: every output site whose
    receptive field holds >= 1 active input, enumerated per axis as the
    range [ceil((in+p-k+1)/s), floor((in+p)/s)]. Returns (keys, coords,
    nnz, out_shape)."""
    k, s, p = triple(kernel_size), triple(stride), triple(padding)
    out_shape = conv_out_shape(st.spatial_shape, kernel_size, stride, padding)
    n_cand = [-(-k[i] // s[i]) for i in range(3)]
    zyx = st.coords[:, 1:4].long()
    per_axis = []
    for i in range(3):
        a = zyx[:, i] + p[i] - k[i] + 1
        lo = -((-a) // s[i])
        hi = (zyx[:, i] + p[i]) // s[i]
        r = lo[None, :] + torch.arange(n_cand[i], device=zyx.device)[:, None]
        per_axis.append((r, (r <= hi[None, :]) & (r >= 0) & (r < out_shape[i])))
    (rz, okz), (ry, oky), (rx, okx) = per_axis
    cz, cy, cx = n_cand
    N = zyx.shape[0]
    shp = (cz, cy, cx, N)
    ok = (okz[:, None, None, :] & oky[None, :, None, :] & okx[None, None, :, :]
          & st.valid[None, None, None, :])
    b = st.coords[:, 0].long()
    cand = torch.stack([
        b.expand(shp), rz[:, None, None, :].expand(shp),
        ry[None, :, None, :].expand(shp), rx[None, None, :, :].expand(shp),
    ], dim=-1).reshape(-1, 4)
    cand = torch.where(ok.reshape(-1)[:, None], cand, torch.full_like(cand, -1))
    cand_keys = linear_key(cand, out_shape, st.batch_size)
    cells = out_shape[0] * out_shape[1] * out_shape[2]
    keys, nnz = _unique_capped(cand_keys, out_capacity, cells, st.batch_size)
    return keys, key_to_coords(keys, out_shape), nnz, out_shape


def subm_rulebook(st: SparseTensor, kernel_size):
    """(in_idx, found), both (K, N): neighbour at coords + tap - k//2."""
    k = triple(kernel_size)
    return cuda_conv.conv_rulebook(st.keys, st.coords, st.spatial_shape, k, 1,
                                   tuple(v // 2 for v in k))


def conv_rulebook(in_st: SparseTensor, out_coords, kernel_size, stride, padding):
    """(in_idx, found), both (K, M): input at out*s - p + tap."""
    return cuda_conv.conv_rulebook(in_st.keys, out_coords, in_st.spatial_shape, kernel_size,
                                   stride, padding)


class MaskedBatchNorm(nn.BatchNorm1d):
    """BatchNorm over active rows (the JAX package's `MaskedBatchNorm`); rows
    outside `mask` come out 0. Holds the reference's BN tensors (weight,
    bias, running_mean, running_var, num_batches_tracked).

    Eval mode normalises with the running statistics. Train mode uses the
    mean and the biased variance of the active rows, and moves the running
    statistics by `momentum` towards them -- the biased variance, as the
    JAX package and flax do (torch's own BatchNorm moves them towards the
    unbiased one). In a data-parallel run the active rows are those of
    every rank: the count and the sum, then the squared deviations, are
    summed over the ranks (the JAX package's `axis_name` path,
    `btcdet_tpu/ops/sparse.py:1445-1456`), through the differentiable
    all-reduce. The sums are taken in float64 and the statistics rounded
    to float32 once, so they come out the same bits however the rows are
    split over ranks: a data-parallel forward is the one-process forward."""

    def __init__(self, num_features: int, eps: float = 1e-3, momentum: float = 0.01):
        super().__init__(num_features, eps=eps, momentum=momentum)

    def forward(self, x, mask):
        xf = x.float()
        if self.training:
            m = mask.float()[:, None]
            stats = all_reduce_sum(torch.cat([(xf * m).double().sum(0),
                                              m.double().sum().reshape(1)]), differentiable=True)
            cnt = stats[-1].detach().clamp(min=1.0)
            mean = (stats[:-1] / cnt).float()
            var = (all_reduce_sum(((xf - mean) ** 2 * m).double().sum(0), differentiable=True)
                   / cnt).float()
            with torch.no_grad():
                mom = self.momentum
                self.running_mean.mul_(1 - mom).add_(mom * mean.detach())
                self.running_var.mul_(1 - mom).add_(mom * var.detach())
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return torch.where(mask[:, None], y, torch.zeros_like(y)).to(x.dtype)


class _SparseConv(nn.Module):
    """Sparse conv with the reference spconv weight layout
    (kz, ky, kx, Cin, Cout) stored as `weight`; no bias."""

    subm = False

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1, padding=0,
                 indice_key=None, frame_capacity=None):
        super().__init__()
        self.kernel_size = triple(kernel_size)
        self.stride = triple(stride) if not self.subm else (1, 1, 1)
        self.padding = (tuple(k // 2 for k in self.kernel_size) if self.subm
                        else triple(padding))
        self.indice_key = indice_key
        self.frame_capacity = tuple(frame_capacity) if frame_capacity else (None, None)
        self.in_channels, self.out_channels = int(in_channels), int(out_channels)
        self.weight = nn.Parameter(torch.empty(*self.kernel_size, self.in_channels,
                                               self.out_channels))
        nn.init.normal_(self.weight, std=(1.0 / (self.in_channels * self.weight[..., 0, 0].numel())) ** 0.5)

    def _sites(self, st, cache):
        """(keys, coords, nnz, out_shape, stride, padding) of the output
        sites and the geometry that pairs inputs with them."""
        if self.subm:
            return st.keys, st.coords, st.nnz, st.spatial_shape, self.stride, self.padding
        if self.indice_key and ("sites", self.indice_key) in cache:
            return shared_sites(cache, self.indice_key, self.kernel_size, self.stride,
                                self.padding)
        per_frame = self.frame_capacity[0 if self.training else 1]
        cap = per_frame * st.batch_size if per_frame else st.capacity
        sites = conv_output_sites(st, self.kernel_size, self.stride, self.padding, cap)
        if self.indice_key:
            cache[("sites", self.indice_key)] = sites
            cache[("sites_geometry", self.indice_key)] = (self.kernel_size, self.stride,
                                                          self.padding)
        return (*sites, self.stride, self.padding)

    def forward(self, st: SparseTensor, cache: dict) -> SparseTensor:
        keys, coords, nnz, out_shape, stride, padding = self._sites(st, cache)
        K = self.kernel_size[0] * self.kernel_size[1] * self.kernel_size[2]
        nbr = neighbor_map_cached(cache, st, keys, coords, self.kernel_size, stride, padding)
        out = cuda_conv.SparseConvFunction.apply(
            st.features.to(activation_dtype()),
            self.weight.reshape(K, self.in_channels, self.out_channels), st.keys, st.coords,
            keys, coords, (st.spatial_shape, tuple(int(v) for v in out_shape), st.batch_size,
                           self.kernel_size, stride, padding, self.subm), nbr)
        out = torch.where((keys != INT32_MAX)[:, None], out, torch.zeros_like(out))
        return SparseTensor(out.to(st.features.dtype), coords, keys, nnz,
                            tuple(int(v) for v in out_shape), st.batch_size)


class SubMConv3d(_SparseConv):
    """Submanifold sparse conv: output sites == input sites."""

    subm = True


class SparseConv3d(_SparseConv):
    """Strided sparse conv: new output sites, capped per frame at
    `frame_capacity` = (train capacity, eval capacity), picked by the
    module's mode (None: the input capacity), and cached under
    `indice_key`."""


def shared_sites(cache: dict, indice_key: str, kernel_size, stride, padding):
    """(keys, coords, nnz, out_shape, stride, padding) for a conv or pool
    over the output sites that a strided conv cached under `indice_key`.

    The JAX package shares one pair set per (indice_key, kernel size): its
    CPU path through the rulebook cache, its TPU path through the query-key
    cache. So a layer whose kernel equals that of the conv that made the
    sites pairs inputs with that conv's stride and padding, whatever its
    own (the level-3 occ downsamplers ask for padding (1,1,1) and get
    conv4's (0,1,1)); a layer with another kernel (`avgpool`'s k=2) uses its
    own. Raises when nothing is cached under the key."""
    if ("sites", indice_key) not in cache:
        raise RuntimeError(f"no output sites cached under {indice_key!r}; run the strided "
                           "conv that makes them first")
    keys, coords, nnz, out_shape = cache[("sites", indice_key)]
    kernel, site_stride, site_padding = cache[("sites_geometry", indice_key)]
    if triple(kernel_size) == kernel:
        return keys, coords, nnz, out_shape, site_stride, site_padding
    return keys, coords, nnz, out_shape, triple(stride), triple(padding)


def neighbor_map_cached(cache: dict, in_st: SparseTensor, out_keys, out_coords, kernel_size,
                        stride, padding):
    """The (K, M) neighbour map (`cuda_conv.neighbor_map`) pairing the rows
    of `in_st` with the output sites (`out_keys`, `out_coords`) under
    (kernel, stride, padding), built once per forward `cache` and shared by
    every conv or pool that pairs the same input key table with the same
    sites the same way: the subm convs of one indice_key, the strided convs
    that read one table onto one cached site set (conv3 and down2[0]), and
    the occ-code pools, whose table shares its keys with the trunk's (a k=3
    pool reads the map of the strided conv that made its sites; `avgpool`'s
    k=2 builds its own). The entry
    is keyed by the identity of both key tables and by the geometry, so a
    map never crosses tables or geometries (the JAX package shares pair
    sets per (indice_key, kernel size) instead, ROADMAP Queue 3)."""
    geo = (triple(kernel_size), triple(stride), triple(padding))
    key = ("nbr", id(in_st.keys), id(out_keys), geo)
    hit = cache.get(key)
    if hit is not None and hit[0] is in_st.keys and hit[1] is out_keys:
        return hit[2]
    nbr = cuda_conv.neighbor_map(in_st.keys, out_coords, in_st.spatial_shape, in_st.batch_size,
                                 *geo)
    cache[key] = (in_st.keys, out_keys, nbr)
    return nbr


def transpose_map_cached(cache: dict, out_keys, in_coords, out_shape, batch_size: int,
                         kernel_size, stride, padding):
    """The (K, N) transpose-query map (`cuda_conv.neighbor_map(...,
    transpose=True)`) of a strided pairing: for each input site and tap,
    the row of the output key table `out_keys` that reads it, or -1. Built
    once per forward `cache` and (output table, input sites, geometry),
    keyed by the tables' identity like `neighbor_map_cached`; a pool's
    backward reads it."""
    geo = (triple(kernel_size), triple(stride), triple(padding))
    key = ("tnbr", id(out_keys), id(in_coords), geo)
    hit = cache.get(key)
    if hit is not None and hit[0] is out_keys and hit[1] is in_coords:
        return hit[2]
    tnbr = cuda_conv.neighbor_map(out_keys, in_coords, out_shape, batch_size, *geo,
                                  transpose=True)
    cache[key] = (out_keys, in_coords, tnbr)
    return tnbr


class SparsePoolFunction(torch.autograd.Function):
    """K2 (`cuda_pool.sparse_pool` / `sparse_sum_pool`) with its backward
    (`cuda_pool.sparse_pool_grad` / `sparse_sum_pool_grad`), the
    counterpart of the JAX package's `_pallas_pool_ad`.

    apply(features, mode, in_keys, in_coords, out_keys, out_coords, geo,
    nbr, cache) with mode "max" or "sum", geo = (in_shape, out_shape,
    batch_size, kernel, stride, padding), nbr the forward's (K, M) map and
    `cache` the forward's cache, where the backward keeps the
    transpose-query map (`transpose_map_cached`). features float32."""

    @staticmethod
    def forward(ctx, features, mode, in_keys, in_coords, out_keys, out_coords, geo, nbr, cache):
        in_shape, _, batch, kernel, stride, padding = geo
        fn = cuda_pool.sparse_pool if mode == "max" else cuda_pool.sparse_sum_pool
        out = fn(features, in_keys, out_coords, in_shape, batch, kernel, stride, padding, nbr=nbr)
        ctx.mode, ctx.geo, ctx.cache = mode, geo, cache
        # the tables the transpose-query map is cached under, by identity
        ctx.tables = (out_keys, in_coords)
        if mode == "max":
            ctx.save_for_backward(features, out, nbr)
        return out

    @staticmethod
    def backward(ctx, g):
        _, out_shape, batch, kernel, stride, padding = ctx.geo
        tnbr = transpose_map_cached(ctx.cache, *ctx.tables, out_shape, batch, kernel, stride,
                                    padding)
        g = g.float().contiguous()
        if ctx.mode == "max":
            features, out, nbr = ctx.saved_tensors
            df = cuda_pool.sparse_pool_grad(features, out, g, nbr, tnbr)
        else:
            df = cuda_pool.sparse_sum_pool_grad(g, tnbr)
        return df, None, None, None, None, None, None, None, None


class _SparsePool(nn.Module):
    """A strided sparse pool over the output sites that an earlier strided
    conv cached under the same `indice_key` (`shared_sites`); no
    parameters (kernel K2 on CUDA tensors). An input that requires a
    gradient goes through `SparsePoolFunction`."""

    mode = ""

    def __init__(self, kernel_size, stride, padding, indice_key: str):
        super().__init__()
        self.kernel_size, self.stride, self.padding = (triple(kernel_size), triple(stride),
                                                       triple(padding))
        self.indice_key = indice_key

    def _scale(self, out):
        return out

    def forward(self, st: SparseTensor, cache: dict) -> SparseTensor:
        keys, coords, nnz, out_shape, stride, padding = shared_sites(
            cache, self.indice_key, self.kernel_size, self.stride, self.padding)
        # the map of the strided conv that made the sites, where it read the
        # same table with the same geometry; a map of its own otherwise
        nbr = neighbor_map_cached(cache, st, keys, coords, self.kernel_size, stride, padding)
        f = st.features.float()
        geo = (st.spatial_shape, tuple(int(v) for v in out_shape), st.batch_size,
               self.kernel_size, stride, padding)
        if f.requires_grad and torch.is_grad_enabled():
            out = SparsePoolFunction.apply(f, self.mode, st.keys, st.coords, keys, coords, geo,
                                           nbr, cache)
        else:
            fn = cuda_pool.sparse_pool if self.mode == "max" else cuda_pool.sparse_sum_pool
            out = fn(f, st.keys, coords, st.spatial_shape, st.batch_size, self.kernel_size,
                     stride, padding, nbr=nbr)
        return SparseTensor(self._scale(out).to(st.features.dtype), coords, keys, nnz,
                            geo[1], st.batch_size)


class SparseMaxPool3d(_SparsePool):
    """Strided sparse max-pool (spconv `SparseMaxPool3d`): per-channel max
    over the matched inputs of each output site, 0 where none matched
    (`cuda_pool.sparse_pool`). The flagship's occ_conv2 pools onto conv2's
    sites."""

    mode = "max"


class FixedSparseConv3d(_SparsePool):
    """Strided conv with one constant weight, `default_value`, on every tap
    and channel (the reference's `fixspconv` occ-code downsampler,
    `spconv_backbone.py:812-828`; the JAX package's `FixedSparseConv3d`):
    the sum of the matched inputs (`cuda_pool.sparse_sum_pool`), times
    `default_value` after the sum."""

    def __init__(self, kernel_size, stride, padding, indice_key: str,
                 default_value: float = 1.0 / 27):
        super().__init__(kernel_size, stride, padding, indice_key)
        self.default_value = float(default_value)

    mode = "sum"

    def _scale(self, out):
        return out * self.default_value
