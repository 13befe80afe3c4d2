"""Sparse conv with gradients: CUDA kernels K1 (`csrc/sparse_nbr.cu` and
`csrc/sparse_conv.cu`) and K3 (`csrc/sparse_conv_dw.cu`) beside their
plain PyTorch versions (counterpart of `btcdet_tpu/ops/pallas_conv.py` and
of the two `custom_vjp` bridges in `btcdet_tpu/ops/sparse.py`).

The forward computes, for output sites `out_coords` of a conv over a
key-sorted input table,

    out[m] = sum_k features[match(q(m, k))] @ weights[k]

with q(m, k) the y-major key of the input site out*stride - pad + tap_k
(taps in the canonical (dz, dy, dx) order of the weights), 0 for taps
with no active input, and 0 for padding rows (b < 0). A submanifold conv
is stride 1, pad k//2 with `out_coords` = the input coords.

K1 runs in two kernels: `neighbor_map` writes the (K, M) int32 map of
matched input rows (-1 for none) once per (input table, output sites,
geometry), and the gather-GEMM (`sparse_conv`, bf16 on the tensor cores,
f32 on exact FMAs) reads it. `sparse.neighbor_map_cached` shares one map
between the convs of a forward that pair alike.

The backward (`SparseConvFunction`) is:
  df  K1 again (`sparse_conv_df`): for a submanifold conv over the
      forward's own map with tap-reversed, transposed weights; for a
      strided conv over a transpose-query map of the forward's output
      table, input site s reading output (s + pad - tap_k) / stride where
      it divides exactly;
  dW  K3 (`sparse_conv_dw`): dW[k] = sum_m features[nbr[k, m]]^T g[m] over
      the forward's map, compacted per tap into its matched pairs
      (`tap_pairs`); bf16 features round g to bf16 first, as the TPU
      kernel does, and the products run on the tensor cores.

Each wrapper takes the plain version for CPU tensors only; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import itertools

import numpy as np
import torch

from . import kernel_build

# kernel launches made by the wrappers below (CPU calls take the plain
# versions and are not counted): the neighbour-map builds (`neighbor_map`),
# the forward gather-GEMM (`sparse_conv`), the df of the backward
# (`sparse_conv_df`, K1 too), K3's per-tap compaction of the map
# (`tap_pairs`) and the weight gradient (`sparse_conv_dw`, K3)
nbr_launches = 0
launches = 0
df_launches = 0
pair_launches = 0
dw_launches = 0

# K3's workspace of per-chunk partial weight gradients is held below this
WS_BYTES = 64 << 20
# ... and the partials of the chunks of one call below this: the reduction
# reads back every partial written, so at the wide levels more chunks cost
# more in partial tiles than the blocks they add, while the narrow levels
# (small tiles) gain from every block up to the chunk limit
DW_PARTIAL_BYTES = 32 << 20
# rows of one tap that one block of K3's compaction counts
PAIR_BLOCK_ROWS = 1024

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


def sparse_conv_plain(features, in_keys, out_coords, weights, in_spatial_shape,
                      batch_size, kernel_size, stride, padding, transpose: bool = False):
    """The plain PyTorch version of K1: rulebook + gather + batched matmul."""
    idx, found = conv_rulebook(in_keys, out_coords, in_spatial_shape, kernel_size, stride,
                               padding, transpose)
    return apply_rulebook_matmul(features, idx, found, weights)


def apply_map_dw(features, nbr, g):
    """The plain K3 over a neighbour map: the matched rows gathered, then
    the transpose of `apply_map_matmul`'s batched matmul, (K, Cin, Cout)
    f32. bf16 features take g rounded to bf16, as the TPU kernel does
    (`pallas_conv._make_kernel_dw`), so every product is exact in f32;
    f32 features keep g in f32."""
    a = features.float()[nbr.clamp(min=0).long()]                   # (K, M, Cin)
    a = torch.where((nbr >= 0)[..., None], a, torch.zeros((), dtype=a.dtype, device=a.device))
    gg = g.to(features.dtype).float()
    return torch.bmm(a.transpose(1, 2), gg[None].expand(a.shape[0], *gg.shape))


def sparse_conv_dw_plain(features, in_keys, out_coords, g, in_spatial_shape, batch_size,
                         kernel_size, stride, padding, nbr=None):
    """The plain PyTorch version of K3 over the map `nbr` of these pairs
    (`neighbor_map_plain`, built here when None): `apply_map_dw`."""
    if nbr is None:
        nbr = neighbor_map_plain(in_keys, out_coords, in_spatial_shape, kernel_size, stride,
                                 padding)
    return apply_map_dw(features, nbr, g)


def tap_pairs_plain(nbr):
    """The plain version of K3's compaction: (pairs (K, M, 2) int32,
    counts (K,) int32), tap k's matched (input row, output row) pairs in
    ascending output row in pairs[k, :counts[k]], -1 past them."""
    K, M = nbr.shape
    pairs = torch.full((K, M, 2), -1, dtype=torch.int32, device=nbr.device)
    counts = (nbr >= 0).sum(1).to(torch.int32)
    for k in range(K):
        m = torch.nonzero(nbr[k] >= 0).squeeze(1)
        pairs[k, :m.numel(), 0] = nbr[k, m]
        pairs[k, :m.numel(), 1] = m.to(torch.int32)
    return pairs, counts


_NBR_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                 + [ctypes.c_int] * 13 + [ctypes.c_void_p])
_K1_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
_PAIR_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4)
_K3_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
                + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def _lib(name: str, fn: str, argtypes):
    lib = kernel_build.load(name)
    f = getattr(lib, fn)
    if f.argtypes is None:
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return f


def _check_pairs(who, in_keys, out_coords, in_spatial_shape, batch_size, kernel_size):
    """Validate a pair search's inputs; returns (N, M, K)."""
    if in_keys.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {in_keys.device}")
    kz, ky, kx = triple(kernel_size)
    nz, ny, nx = (int(v) for v in in_spatial_shape)
    K = kz * ky * kx
    if in_keys.dtype != torch.int32 or out_coords.dtype != torch.int32:
        raise TypeError(f"{who}: keys and coords must be int32")
    if K > 27 or in_keys.dim() != 1 or out_coords.dim() != 2 or out_coords.shape[1] != 4:
        raise ValueError(f"{who}: bad shapes keys {tuple(in_keys.shape)} "
                         f"coords {tuple(out_coords.shape)} kernel {(kz, ky, kx)}")
    if batch_size * nz * ny * nx >= INT32_MAX:
        raise ValueError(f"{who}: grid x batch overflows int32 keys")
    if out_coords.device != in_keys.device:
        raise ValueError(f"{who}: tensors on different devices")
    return in_keys.shape[0], out_coords.shape[0], K


def _check(who, features, in_keys, out_coords, weights, in_spatial_shape, batch_size,
           kernel_size):
    """Validate a kernel call's inputs; returns (N, Cin, M, K)."""
    if features.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {features.device}")
    if features.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{who}: features {features.dtype}")
    N, M, K = _check_pairs(who, in_keys, out_coords, in_spatial_shape, batch_size, kernel_size)
    cin = features.shape[1]
    if features.shape[0] != N:
        raise ValueError(f"{who}: features {tuple(features.shape)} for {N} keys")
    if weights is not None and weights.dtype != features.dtype:
        raise TypeError(f"{who}: features {features.dtype} / weights {weights.dtype}")
    if weights is not None and tuple(weights.shape[:2]) != (K, cin):
        raise ValueError(f"{who}: weights {tuple(weights.shape)} for features "
                         f"{tuple(features.shape)} and {K} taps")
    for t in (in_keys,) + (() if weights is None else (weights,)):
        if t.device != features.device:
            raise ValueError(f"{who}: tensors on different devices")
    return N, cin, M, K


def neighbor_map(in_keys, out_coords, in_spatial_shape, batch_size, kernel_size, stride,
                 padding, transpose: bool = False):
    """(K, M) int32 neighbour map (the map kernel, `csrc/sparse_nbr.cu`):
    the row of the sorted key table `in_keys` that tap k of output row m
    reads, or -1. `transpose` selects the transpose query (the df of a
    strided conv: `in_keys` is then its output table, `out_coords` its
    input sites)."""
    if in_keys.device.type == "cpu":
        return neighbor_map_plain(in_keys, out_coords, in_spatial_shape, kernel_size, stride,
                                  padding, transpose)
    N, M, K = _check_pairs("neighbor_map", in_keys, out_coords, in_spatial_shape, batch_size,
                           kernel_size)
    in_keys, out_coords = in_keys.contiguous(), out_coords.contiguous()
    nbr = torch.empty((K, M), dtype=torch.int32, device=in_keys.device)
    if M == 0:
        return nbr
    stream = torch.cuda.current_stream(in_keys.device).cuda_stream
    err = _lib("sparse_nbr", "sparse_conv_nbr", _NBR_ARGTYPES)(
        in_keys.data_ptr(), N, out_coords.data_ptr(), M, nbr.data_ptr(), *triple(kernel_size),
        *triple(stride), *triple(padding), *(int(v) for v in in_spatial_shape), int(transpose),
        stream)
    if err != 0:
        raise RuntimeError(f"neighbor_map kernel launch failed: cudaError {err}")
    global nbr_launches
    nbr_launches += 1
    return nbr


def check_map(who, nbr, K, M, device):
    """Raise unless nbr is an int32 (K, M) neighbour map on `device`."""
    if nbr.dtype != torch.int32 or tuple(nbr.shape) != (K, M) or nbr.device != device:
        raise ValueError(f"{who}: neighbour map {nbr.dtype} {tuple(nbr.shape)} on {nbr.device} "
                         f"for {K} taps and {M} output rows")


def _launch_k1(who, features, nbr, weights):
    """K1's gather-GEMM over the map `nbr`: (out (M, Cout) f32, launched).
    A bf16 Cin or Cout that is not a multiple of 8 is zero-padded here
    (features and weights), so that the kernel's 16-byte copies align."""
    K, cin, cout = weights.shape
    M = nbr.shape[1]
    if cout > 256:
        raise ValueError(f"{who}: Cout {cout} > 256")
    check_map(who, nbr, K, M, features.device)
    cin_k, cout8 = cin, cout
    if features.dtype == torch.bfloat16:
        cin_k, cout8 = -(-cin // 8) * 8, -(-cout // 8) * 8
        if cin_k != cin:
            features = torch.nn.functional.pad(features, (0, cin_k - cin))
        if (cin_k, cout8) != (cin, cout):
            weights = torch.nn.functional.pad(weights, (0, cout8 - cout, 0, cin_k - cin))
    features, nbr, weights = features.contiguous(), nbr.contiguous(), weights.contiguous()
    out = torch.empty((M, cout), dtype=torch.float32, device=features.device)
    if M == 0:
        return out, False
    stream = torch.cuda.current_stream(features.device).cuda_stream
    err = _lib("sparse_conv", "sparse_conv_fwd", _K1_ARGTYPES)(
        features.data_ptr(), int(features.dtype == torch.bfloat16), nbr.data_ptr(), M, K,
        weights.data_ptr(), out.data_ptr(), cin_k, cout, cout8, stream)
    if err != 0:
        raise RuntimeError(f"{who} kernel launch failed: cudaError {err}")
    return out, True


def sparse_conv(features, in_keys, out_coords, weights, in_spatial_shape, batch_size,
                kernel_size, stride, padding, nbr=None):
    """(M, Cout) float32 sparse-conv forward (K1).

    features (N, Cin) f32 or bf16; in_keys (N,) int32 ascending, padding
    INT32_MAX; out_coords (M, 4) int32; weights (K, Cin, Cout) in the
    features' dtype; nbr the (K, M) map of these pairs (`neighbor_map`),
    built here when None.
    """
    if features.device.type != "cpu":
        _check("sparse_conv", features, in_keys, out_coords, weights, in_spatial_shape,
               batch_size, kernel_size)
    if nbr is None:
        nbr = neighbor_map(in_keys, out_coords, in_spatial_shape, batch_size, kernel_size,
                           stride, padding)
    if features.device.type == "cpu":
        return apply_map_matmul(features, nbr, weights)
    out, launched = _launch_k1("sparse_conv", features, nbr, weights)
    if launched:
        global launches
        launches += 1
    return out


def sparse_conv_df(g, table_keys, query_coords, weights, table_spatial_shape, batch_size,
                   kernel_size, stride, padding, transpose: bool, nbr=None):
    """(M', C) float32: K1 computing the df of a sparse conv's backward.

    g (N', Cout) is the output gradient as a table keyed by `table_keys`
    (sorted, over the grid `table_spatial_shape`); `query_coords` are the
    forward's input sites and `weights` (K, Cout, Cin) the per-tap
    transposed weights (tap-reversed for a submanifold conv). `transpose`
    selects the transpose query of a strided conv. `nbr`: the map of these
    pairs (a submanifold conv's forward map), built here when None."""
    if g.device.type != "cpu":
        _check("sparse_conv_df", g, table_keys, query_coords, weights, table_spatial_shape,
               batch_size, kernel_size)
    if nbr is None:
        nbr = neighbor_map(table_keys, query_coords, table_spatial_shape, batch_size,
                           kernel_size, stride, padding, transpose)
    if g.device.type == "cpu":
        return apply_map_matmul(g, nbr, weights)
    out, launched = _launch_k1("sparse_conv_df", g, nbr, weights)
    if launched:
        global df_launches
        df_launches += 1
    return out


def dw_chunks(M: int, K: int, cin: int, cout: int) -> tuple[int, int]:
    """(n_chunks, rows_per_chunk) of K3's split of each tap's pair list:
    chunks of at least 256 pairs, at most 256 of them, and partials within
    DW_PARTIAL_BYTES (and the workspace within WS_BYTES). Depends on the
    shapes alone, so the result is repeatable."""
    per_chunk = K * cin * cout * 4
    n = max(1, min(-(-M // 256), 256, DW_PARTIAL_BYTES // per_chunk, WS_BYTES // per_chunk))
    return n, -(-M // n)


def tap_pairs(nbr):
    """K3's compaction of a (K, M) neighbour map (`sparse_conv_dw_pairs` in
    `csrc/sparse_conv_dw.cu`): (pairs (K, M, 2) int32, counts (K,) int32)
    with tap k's matched (input row, output row) pairs in ascending output
    row in pairs[k, :counts[k]]; the entries past counts[k] are undefined
    (the plain version, `tap_pairs_plain`, fills them with -1)."""
    if nbr.device.type == "cpu":
        return tap_pairs_plain(nbr)
    if (nbr.device.type != "cuda" or nbr.dtype != torch.int32 or nbr.dim() != 2
            or not 0 < nbr.shape[0] <= 27):
        raise ValueError(f"tap_pairs: bad neighbour map {nbr.dtype} {tuple(nbr.shape)} on "
                         f"{nbr.device}")
    K, M = nbr.shape
    nbr = nbr.contiguous()
    pairs = torch.empty((K, M, 2), dtype=torch.int32, device=nbr.device)
    counts = torch.zeros((K,), dtype=torch.int32, device=nbr.device)
    if M == 0:
        return pairs, counts
    blk = torch.empty((K * -(-M // PAIR_BLOCK_ROWS),), dtype=torch.int32, device=nbr.device)
    stream = torch.cuda.current_stream(nbr.device).cuda_stream
    err = _lib("sparse_conv_dw", "sparse_conv_dw_pairs", _PAIR_ARGTYPES)(
        nbr.data_ptr(), M, K, blk.data_ptr(), pairs.data_ptr(), counts.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"tap_pairs kernel launch failed: cudaError {err}")
    global pair_launches
    pair_launches += 1
    return pairs, counts


def sparse_conv_dw(features, in_keys, out_coords, g, in_spatial_shape, batch_size,
                   kernel_size, stride, padding, nbr=None):
    """(K, Cin, Cout) float32 weight gradient (K3): dW[k] = sum over the
    output rows m of features[nbr[k, m]]^T g[m], every match counted.

    features (N, Cin) f32 or bf16; in_keys, out_coords, the geometry as
    `sparse_conv`; g (M, Cout) float32, rounded to bf16 for bf16 features;
    nbr the forward's (K, M) map of these pairs (`neighbor_map`), built
    here when None. The map is compacted per tap (`tap_pairs`), then the
    kernel contracts over the matched pairs only."""
    if features.device.type != "cpu":
        _check("sparse_conv_dw", features, in_keys, out_coords, None, in_spatial_shape,
               batch_size, kernel_size)
    if nbr is None:
        nbr = neighbor_map(in_keys, out_coords, in_spatial_shape, batch_size, kernel_size,
                           stride, padding)
    if features.device.type == "cpu":
        return apply_map_dw(features, nbr, g)
    cin = features.shape[1]
    K, M = nbr.shape[0], out_coords.shape[0]
    check_map("sparse_conv_dw", nbr, K, M, features.device)
    if g.dtype != torch.float32 or g.dim() != 2 or g.shape[0] != M or g.device != features.device:
        raise ValueError(f"sparse_conv_dw: g {g.dtype} {tuple(g.shape)} for {M} output rows")
    cout = g.shape[1]
    if M == 0:
        return torch.zeros((K, cin, cout), dtype=torch.float32, device=features.device)
    bf16 = features.dtype == torch.bfloat16
    cin_k, cout_k = cin, cout
    if bf16:
        # the TPU kernel's rounding of g; 16-byte rows for the cp.async copies
        g = g.to(torch.bfloat16)
        cin_k, cout_k = -(-cin // 8) * 8, -(-cout // 8) * 8
        if cin_k != cin:
            features = torch.nn.functional.pad(features, (0, cin_k - cin))
        if cout_k != cout:
            g = torch.nn.functional.pad(g, (0, cout_k - cout))
    features, g = features.contiguous(), g.contiguous()
    pairs, counts = tap_pairs(nbr)
    n_chunks, rows = dw_chunks(M, K, cin, cout)
    if n_chunks == 1:
        dw = ws = torch.zeros((K, cin, cout), dtype=torch.float32, device=features.device)
    else:
        dw = torch.empty((K, cin, cout), dtype=torch.float32, device=features.device)
        ws = torch.empty((n_chunks, K, cin, cout), dtype=torch.float32, device=features.device)
    stream = torch.cuda.current_stream(features.device).cuda_stream
    err = _lib("sparse_conv_dw", "sparse_conv_dw", _K3_ARGTYPES)(
        features.data_ptr(), int(bf16), g.data_ptr(), pairs.data_ptr(), counts.data_ptr(), M, K,
        dw.data_ptr(), ws.data_ptr(), n_chunks, rows, cin, cin_k, cout, cout_k, stream)
    if err != 0:
        raise RuntimeError(f"sparse_conv_dw kernel launch failed: cudaError {err}")
    global dw_launches
    dw_launches += 1
    return dw


class SparseConvFunction(torch.autograd.Function):
    """`sparse_conv` with its backward through K1 (df) and K3 (dW), the
    counterpart of the JAX package's `_pallas_subm_ad` / `_pallas_strided_ad`.

    apply(features, weights, in_keys, in_coords, out_keys, out_coords, geo, nbr)
    with geo = (in_shape, out_shape, batch_size, kernel, stride, padding,
    subm) and nbr the forward's (K, M) neighbour map (`neighbor_map`);
    `weights` (K, Cin, Cout) in any float dtype (the forward runs in the
    features' dtype, dW comes back in the weights' dtype). The df is
    skipped when the features need no gradient; a submanifold conv's df
    reads the forward's map."""

    @staticmethod
    def forward(ctx, features, weights, in_keys, in_coords, out_keys, out_coords, geo, nbr):
        in_shape, _, batch, kernel, stride, padding, _ = geo
        ctx.geo = geo
        ctx.save_for_backward(features, weights, in_keys, in_coords, out_keys, out_coords, nbr)
        return sparse_conv(features, in_keys, out_coords, weights.to(features.dtype), in_shape,
                           batch, kernel, stride, padding, nbr=nbr)

    @staticmethod
    def backward(ctx, g):
        features, weights, in_keys, in_coords, out_keys, out_coords, nbr = ctx.saved_tensors
        in_shape, out_shape, batch, kernel, stride, padding, subm = ctx.geo
        g = g.float().contiguous()
        df = dw = None
        dt = features.dtype
        if ctx.needs_input_grad[0]:
            if subm:
                df = sparse_conv_df(g.to(dt), in_keys, in_coords,
                                    weights.flip(0).transpose(1, 2).to(dt), in_shape, batch,
                                    kernel, 1, padding, transpose=False, nbr=nbr)
            else:
                df = sparse_conv_df(g.to(dt), out_keys, in_coords,
                                    weights.transpose(1, 2).to(dt), out_shape, batch, kernel,
                                    stride, padding, transpose=True)
            df = df.to(dt)
        if ctx.needs_input_grad[1]:
            dw = sparse_conv_dw(features, in_keys, out_coords, g, in_shape, batch, kernel,
                                stride, padding, nbr=nbr).to(weights.dtype)
        return df, dw, None, None, None, None, None, None
