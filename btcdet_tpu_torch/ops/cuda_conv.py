"""Sparse conv with gradients: CUDA kernels K1 (`csrc/sparse_conv.cu`)
and K3 (`csrc/sparse_conv_dw.cu`) beside their plain PyTorch versions
(counterpart of `btcdet_tpu/ops/pallas_conv.py` and of the two
`custom_vjp` bridges in `btcdet_tpu/ops/sparse.py`).

The forward computes, for output sites `out_coords` of a conv over a
key-sorted input table,

    out[m] = sum_k features[match(q(m, k))] @ weights[k]

with q(m, k) the y-major key of the input site out*stride - pad + tap_k
(taps in the canonical (dz, dy, dx) order of the weights), 0 for taps
with no active input, and 0 for padding rows (b < 0). A submanifold conv
is stride 1, pad k//2 with `out_coords` = the input coords.

The backward (`SparseConvFunction`) is:
  df  K1 again (`sparse_conv_df`): for a submanifold conv over the same
      sites with tap-reversed, transposed weights; for a strided conv in
      transpose-query mode over the forward's output table, input site s
      reading output (s + pad - tap_k) / stride where it divides exactly;
  dW  K3 (`sparse_conv_dw`): dW[k] = sum_m features[match(q(m, k))]^T g[m].

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
# versions and are not counted): the forward (`sparse_conv`), the df of
# the backward (`sparse_conv_df`, K1 too) and the weight gradient
# (`sparse_conv_dw`, K3)
launches = 0
df_launches = 0
dw_launches = 0

# K3's workspace of per-chunk partial weight gradients is held below this
WS_BYTES = 64 << 20

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


def sparse_conv_plain(features, in_keys, out_coords, weights, in_spatial_shape,
                      batch_size, kernel_size, stride, padding, transpose: bool = False):
    """The plain PyTorch version of K1: rulebook + gather + batched matmul."""
    idx, found = conv_rulebook(in_keys, out_coords, in_spatial_shape, kernel_size, stride,
                               padding, transpose)
    return apply_rulebook_matmul(features, idx, found, weights)


def sparse_conv_dw_plain(features, in_keys, out_coords, g, in_spatial_shape, batch_size,
                         kernel_size, stride, padding):
    """The plain PyTorch version of K3: the rulebook gather, then the
    transpose of `apply_rulebook_matmul`'s batched matmul. (K, Cin, Cout) f32."""
    idx, found = conv_rulebook(in_keys, out_coords, in_spatial_shape, kernel_size, stride,
                               padding)
    a = features.float()[idx]                                      # (K, M, Cin)
    a = torch.where(found[..., None], a, torch.zeros((), dtype=a.dtype, device=a.device))
    return torch.bmm(a.transpose(1, 2), g.float()[None].expand(a.shape[0], *g.shape))


_K1_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
                + [ctypes.c_int] * 15 + [ctypes.c_void_p])
_K3_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p] + [ctypes.c_int] * 16 + [ctypes.c_void_p])


def _lib(name: str, fn: str, argtypes):
    lib = kernel_build.load(name)
    f = getattr(lib, fn)
    if f.argtypes is None:
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return f


def _check(who, features, in_keys, out_coords, weights, in_spatial_shape, batch_size,
           kernel_size):
    """Validate a kernel call's inputs; returns (N, Cin, M, K)."""
    if features.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {features.device}")
    kz, ky, kx = triple(kernel_size)
    nz, ny, nx = (int(v) for v in in_spatial_shape)
    N, cin = features.shape
    M = out_coords.shape[0]
    K = kz * ky * kx
    if features.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{who}: features {features.dtype}")
    if in_keys.dtype != torch.int32 or out_coords.dtype != torch.int32:
        raise TypeError(f"{who}: keys and coords must be int32")
    if K > 27 or out_coords.shape[1:] != (4,) or in_keys.shape != (N,):
        raise ValueError(f"{who}: bad shapes features {tuple(features.shape)} "
                         f"keys {tuple(in_keys.shape)} coords {tuple(out_coords.shape)} "
                         f"kernel {(kz, ky, kx)}")
    if weights is not None and weights.dtype != features.dtype:
        raise TypeError(f"{who}: features {features.dtype} / weights {weights.dtype}")
    if weights is not None and tuple(weights.shape[:2]) != (K, cin):
        raise ValueError(f"{who}: weights {tuple(weights.shape)} for features "
                         f"{tuple(features.shape)} and {K} taps")
    if batch_size * nz * ny * nx >= INT32_MAX:
        raise ValueError(f"{who}: grid x batch overflows int32 keys")
    for t in (in_keys, out_coords) + (() if weights is None else (weights,)):
        if t.device != features.device:
            raise ValueError(f"{who}: tensors on different devices")
    return N, cin, M, K


def _launch_k1(who, features, in_keys, out_coords, weights, in_spatial_shape, batch_size,
               kernel_size, stride, padding, transpose: bool):
    N, cin, M, K = _check(who, features, in_keys, out_coords, weights, in_spatial_shape,
                          batch_size, kernel_size)
    cout = weights.shape[2]
    if cout > 256:
        raise ValueError(f"{who}: Cout {cout} > 256")
    features, in_keys = features.contiguous(), in_keys.contiguous()
    out_coords, weights = out_coords.contiguous(), weights.contiguous()
    out = torch.empty((M, cout), dtype=torch.float32, device=features.device)
    if M == 0:
        return out, False
    stream = torch.cuda.current_stream(features.device).cuda_stream
    err = _lib("sparse_conv", "sparse_conv_fwd", _K1_ARGTYPES)(
        features.data_ptr(), int(features.dtype == torch.bfloat16), in_keys.data_ptr(), N,
        out_coords.data_ptr(), M, weights.data_ptr(), out.data_ptr(), cin, cout,
        *triple(kernel_size), *triple(stride), *triple(padding),
        *(int(v) for v in in_spatial_shape), int(transpose), stream)
    if err != 0:
        raise RuntimeError(f"{who} kernel launch failed: cudaError {err}")
    return out, True


def sparse_conv(features, in_keys, out_coords, weights, in_spatial_shape, batch_size,
                kernel_size, stride, padding):
    """(M, Cout) float32 sparse-conv forward (K1).

    features (N, Cin) f32 or bf16; in_keys (N,) int32 ascending, padding
    INT32_MAX; out_coords (M, 4) int32; weights (K, Cin, Cout) in the
    features' dtype.
    """
    if features.device.type == "cpu":
        return sparse_conv_plain(features, in_keys, out_coords, weights, in_spatial_shape,
                                 batch_size, kernel_size, stride, padding)
    out, launched = _launch_k1("sparse_conv", features, in_keys, out_coords, weights,
                               in_spatial_shape, batch_size, kernel_size, stride, padding,
                               False)
    if launched:
        global launches
        launches += 1
    return out


def sparse_conv_df(g, table_keys, query_coords, weights, table_spatial_shape, batch_size,
                   kernel_size, stride, padding, transpose: bool):
    """(M', C) float32: K1 computing the df of a sparse conv's backward.

    g (N', Cout) is the output gradient as a table keyed by `table_keys`
    (sorted, over the grid `table_spatial_shape`); `query_coords` are the
    forward's input sites and `weights` (K, Cout, Cin) the per-tap
    transposed weights (tap-reversed for a submanifold conv). `transpose`
    selects the transpose query of a strided conv."""
    if g.device.type == "cpu":
        return sparse_conv_plain(g, table_keys, query_coords, weights, table_spatial_shape,
                                 batch_size, kernel_size, stride, padding, transpose)
    out, launched = _launch_k1("sparse_conv_df", g, table_keys, query_coords, weights,
                               table_spatial_shape, batch_size, kernel_size, stride, padding,
                               transpose)
    if launched:
        global df_launches
        df_launches += 1
    return out


def dw_chunks(M: int, K: int, cin: int, cout: int) -> tuple[int, int]:
    """(n_chunks, rows_per_chunk) of K3's row split: chunks of at least 256
    rows, at most 128 of them, and a workspace of partials within WS_BYTES.
    Depends on the shapes alone, so the result is repeatable."""
    by_ws = max(1, WS_BYTES // (K * cin * cout * 4))
    n = max(1, min(by_ws, -(-M // 256), 128))
    return n, -(-M // n)


def sparse_conv_dw(features, in_keys, out_coords, g, in_spatial_shape, batch_size,
                   kernel_size, stride, padding):
    """(K, Cin, Cout) float32 weight gradient (K3): dW[k] = sum over the
    output rows m of features[match(q(m, k))]^T g[m], every match counted.

    features (N, Cin) f32 or bf16; in_keys, out_coords, the geometry as
    `sparse_conv`; g (M, Cout) float32."""
    if features.device.type == "cpu":
        return sparse_conv_dw_plain(features, in_keys, out_coords, g, in_spatial_shape,
                                    batch_size, kernel_size, stride, padding)
    N, cin, M, K = _check("sparse_conv_dw", features, in_keys, out_coords, None,
                          in_spatial_shape, batch_size, kernel_size)
    if g.dtype != torch.float32 or g.shape[0] != M or g.device != features.device:
        raise ValueError(f"sparse_conv_dw: g {g.dtype} {tuple(g.shape)} for {M} output rows")
    cout = g.shape[1]
    dw = torch.zeros((K, cin, cout), dtype=torch.float32, device=features.device)
    if M == 0:
        return dw
    n_chunks, rows = dw_chunks(M, K, cin, cout)
    ws = (torch.empty((n_chunks, K, cin, cout), dtype=torch.float32, device=features.device)
          if n_chunks > 1 else dw)
    features, in_keys = features.contiguous(), in_keys.contiguous()
    out_coords, g = out_coords.contiguous(), g.contiguous()
    stream = torch.cuda.current_stream(features.device).cuda_stream
    err = _lib("sparse_conv_dw", "sparse_conv_dw", _K3_ARGTYPES)(
        features.data_ptr(), int(features.dtype == torch.bfloat16), in_keys.data_ptr(), N,
        out_coords.data_ptr(), M, g.data_ptr(), dw.data_ptr(), ws.data_ptr(), n_chunks, rows,
        cin, cout, *triple(kernel_size), *triple(stride), *triple(padding),
        *(int(v) for v in in_spatial_shape), stream)
    if err != 0:
        raise RuntimeError(f"sparse_conv_dw kernel launch failed: cudaError {err}")
    global dw_launches
    dw_launches += 1
    return dw


class SparseConvFunction(torch.autograd.Function):
    """`sparse_conv` with its backward through K1 (df) and K3 (dW), the
    counterpart of the JAX package's `_pallas_subm_ad` / `_pallas_strided_ad`.

    apply(features, weights, in_keys, in_coords, out_keys, out_coords, geo)
    with geo = (in_shape, out_shape, batch_size, kernel, stride, padding,
    subm); `weights` (K, Cin, Cout) in any float dtype (the forward runs
    in the features' dtype, dW comes back in the weights' dtype). The df
    is skipped when the features need no gradient."""

    @staticmethod
    def forward(ctx, features, weights, in_keys, in_coords, out_keys, out_coords, geo):
        in_shape, _, batch, kernel, stride, padding, _ = geo
        ctx.geo = geo
        ctx.save_for_backward(features, weights, in_keys, in_coords, out_keys, out_coords)
        return sparse_conv(features, in_keys, out_coords, weights.to(features.dtype), in_shape,
                           batch, kernel, stride, padding)

    @staticmethod
    def backward(ctx, g):
        features, weights, in_keys, in_coords, out_keys, out_coords = ctx.saved_tensors
        in_shape, out_shape, batch, kernel, stride, padding, subm = ctx.geo
        g = g.float().contiguous()
        df = dw = None
        dt = features.dtype
        if ctx.needs_input_grad[0]:
            if subm:
                df = sparse_conv_df(g.to(dt), in_keys, in_coords,
                                    weights.flip(0).transpose(1, 2).to(dt), in_shape, batch,
                                    kernel, 1, padding, transpose=False)
            else:
                df = sparse_conv_df(g.to(dt), out_keys, in_coords,
                                    weights.transpose(1, 2).to(dt), out_shape, batch, kernel,
                                    stride, padding, transpose=True)
            df = df.to(dt)
        if ctx.needs_input_grad[1]:
            dw = sparse_conv_dw(features, in_keys, out_coords, g, in_shape, batch, kernel,
                                stride, padding).to(weights.dtype)
        return df, dw, None, None, None, None, None
