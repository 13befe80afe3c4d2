"""ROI trilinear sampler: CUDA kernel K4 (`csrc/trilinear_pool.cu`) and
its plain PyTorch version (counterpart of `btcdet_tpu/ops/pallas_interp.py`).

Both sample the dense channels-last volume (B, D, H, W, C) at per-roi
points (R, S, 3) given as float voxel coords (z, y, x): 8-corner
trilinear weights, corners outside the volume weigh 0, invalid samples
are 0. The volume may be any strided view with a unit channel stride
(ConvHead passes the permuted view `SparseTensor.dense()` returns; the
kernel reads it in place). The result is (R, S, C) in the volume's dtype:
`pallas_interp._xla_reference_pool` (f32 sums) without the TPU kernel's
24x24-cell roi window, rounded once to that dtype.

`trilinear_pool` takes the plain version for CPU tensors only; a CUDA
tensor launches the kernel or raises. `TrilinearPoolFunction` adds the
gradient with respect to the volume (points and rois are constants, as
the JAX package's `pallas_interp.trilinear_pool_ad`): the scatter-add of
the output gradient over the 8 corner weights that the JAX package runs
as an XLA VJP. `trilinear_pool_grad` computes it with the CUDA kernel
`trilinear_pool_bwd` (an ordered gather by cell, the same bits on every
call) on CUDA tensors and with its plain version
`trilinear_pool_volume_grad` (float `index_add_`) on the CPU.
`trilinear_pool_volume_grad_ordered` is the kernel's order of sums (each
cell's entries in chunks of BWD_CHUNK, Kahan in f32) in plain PyTorch,
equal to the kernel bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import trace
from ..utils.common import trilinear_corners, trilinear_interpolate_dense
from . import kernel_build

# The forward and the volume gradient below count their kernel launches as
# the recorder's counters `launch.trilinear_pool` / `launch.trilinear_pool_grad`
# (CPU calls take the plain versions and are not counted).


def trilinear_pool_plain(volume, zyx, roi_b, valid):
    """8-corner gathers (`common.trilinear_interpolate_dense`) frame by
    frame, f32 accumulate, rounded once to the volume's dtype; rois of no
    frame in [0, B) come out 0."""
    B, C = volume.shape[0], volume.shape[-1]
    R, S, _ = zyx.shape
    out = torch.zeros((R, S, C), dtype=torch.float32, device=volume.device)
    for b in range(B):
        sel = roi_b == b
        pts = zyx[sel].reshape(-1, 3)
        out[sel] = trilinear_interpolate_dense(volume[b], pts).reshape(-1, S, C)
    out = torch.where(valid[..., None], out, torch.zeros((), device=out.device))
    return out.to(volume.dtype)


_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 4
             + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2)


_BWD_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
                 + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_longlong]
                 + [ctypes.c_void_p] * 2)


def _lib():
    lib = kernel_build.load("trilinear_pool")
    if lib.trilinear_pool_fwd.argtypes is None:
        lib.trilinear_pool_fwd.argtypes = _ARGTYPES
        lib.trilinear_pool_fwd.restype = ctypes.c_int
        lib.trilinear_pool_bwd.argtypes = _BWD_ARGTYPES
        lib.trilinear_pool_bwd.restype = ctypes.c_int
        lib.trilinear_pool_bwd_workspace.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 5
        lib.trilinear_pool_bwd_workspace.restype = ctypes.c_longlong
    return lib


def trilinear_pool(volume, zyx, roi_b, valid):
    """(R, S, C) trilinear samples in the volume's dtype.

    volume (B, D, H, W, C) f32 or bf16, any strides with a unit channel
    stride (on the card also: C and the other strides multiples of 8, the
    data 16-byte aligned); zyx (R, S, 3) f32 voxel coords; roi_b (R,) batch
    index of each roi; valid (R, S) bool."""
    if volume.device.type == "cpu":
        return trilinear_pool_plain(volume, zyx, roi_b, valid)
    if volume.device.type != "cuda":
        raise ValueError(f"trilinear_pool: unsupported device {volume.device}")
    B, D, H, W, C = volume.shape
    R, S, three = zyx.shape
    if volume.dtype not in (torch.float32, torch.bfloat16) or zyx.dtype != torch.float32:
        raise TypeError(f"trilinear_pool: volume {volume.dtype} / points {zyx.dtype}")
    if three != 3 or valid.shape != (R, S) or roi_b.shape != (R,):
        raise ValueError(f"trilinear_pool: bad shapes points {tuple(zyx.shape)} "
                         f"valid {tuple(valid.shape)} rois {tuple(roi_b.shape)}")
    strides = volume.stride()
    if (strides[4] != 1 or C % 8 or C > 2048 or any(s % 8 for s in strides[:4])
            or volume.data_ptr() % 16):
        raise ValueError(f"trilinear_pool: volume strides {strides} with C={C}: the kernel "
                         "reads 8-channel rows of 16 bytes (unit channel stride, C and the "
                         "other strides multiples of 8, C <= 2048)")
    for t in (zyx, roi_b, valid):
        if t.device != volume.device:
            raise ValueError("trilinear_pool: tensors on different devices")
    zyx = zyx.contiguous()
    valid_u8 = valid.to(torch.uint8).contiguous()
    roi_b32 = roi_b.to(torch.int32).contiguous()
    out = torch.empty((R, S, C), dtype=volume.dtype, device=volume.device)
    if R == 0 or S == 0:
        return out
    stream = torch.cuda.current_stream(volume.device).cuda_stream
    err = _lib().trilinear_pool_fwd(
        volume.data_ptr(), int(volume.dtype == torch.bfloat16), B, D, H, W, C, *strides[:4],
        zyx.data_ptr(), valid_u8.data_ptr(), roi_b32.data_ptr(), R, S, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"trilinear_pool kernel launch failed: cudaError {err}")
    trace.count("launch.trilinear_pool")
    return out


def trilinear_pool_volume_grad(g, volume_shape, zyx, roi_b, valid, dtype=torch.float32):
    """(B, D, H, W, C) gradient of `trilinear_pool` with respect to the
    volume: each valid sample adds g * w to its in-volume corners. The
    weights follow the forward's f32 arithmetic; the products and sums are
    in `dtype` (float32, or float64 for a reference of the sum)."""
    B, D, H, W, C = volume_shape
    ok = valid & (roi_b >= 0)[:, None] & (roi_b < B)[:, None]
    base = roi_b.long()[:, None].expand(valid.shape) * (D * H * W)
    grad = torch.zeros((B * D * H * W, C), dtype=dtype, device=g.device)
    gf = g.to(dtype).reshape(-1, C)
    for lin, w in trilinear_corners(zyx, (D, H, W)):
        w = torch.where(ok, w, torch.zeros_like(w)).reshape(-1).to(dtype)
        grad.index_add_(0, (base + lin).reshape(-1), gf * w[:, None])
    return grad.reshape(B, D, H, W, C)


# entries a chunk of `trilinear_pool_bwd` sums in order (CH of
# csrc/trilinear_pool.cu); its cell keys are sorted by digits of
# BWD_RADIX_BITS, one pass each
BWD_CHUNK = 64
BWD_RADIX_BITS = 10


def bwd_key_count(volume_shape) -> int:
    """Cell keys of `trilinear_pool_bwd` on a (B, D, H, W, ...) volume:
    tiles of 8 x 8 cells in (y, x) over D rounded up to even (key_count in
    csrc/trilinear_pool.cu)."""
    B, D, H, W = volume_shape[:4]
    return B * -(-H // 8) * -(-W // 8) * -(-D // 2) * 2 * 64


def _corner_entries(zyx, roi_b, valid, volume_shape):
    """(cell, w) of every (sample, corner) entry e = 8 * (r * S + s) +
    corner, in entry order: the corner's linear (b, z, y, x) cell, -1 for a
    corner outside the volume or a sample that is invalid or of no frame in
    [0, B), and its weight in the forward's f32 arithmetic (0 past the
    volume; an in-volume corner may weigh 0 too and still counts)."""
    B, D, H, W, _ = volume_shape
    ok = valid & (roi_b >= 0)[:, None] & (roi_b < B)[:, None]
    base = roi_b.long()[:, None].expand(valid.shape) * (D * H * W)
    z, y, x = zyx[..., 0], zyx[..., 1], zyx[..., 2]
    zi0, yi0, xi0 = torch.floor(z).long(), torch.floor(y).long(), torch.floor(x).long()
    cells, ws = [], []
    for (lin, w), (dz, dy, dx) in zip(trilinear_corners(zyx, (D, H, W)),
                                      [(a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1)]):
        zi, yi, xi = zi0 + dz, yi0 + dy, xi0 + dx
        inb = ok & (zi >= 0) & (zi < D) & (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        cells.append(torch.where(inb, base + lin, torch.full_like(lin, -1)))
        ws.append(w)
    return torch.stack(cells, -1).reshape(-1), torch.stack(ws, -1).reshape(-1)


def _kahan(s, c, x):
    """One compensated f32 step (round-to-nearest, no fused ops), as the
    kernel's `kahan_add`: returns the new (s, c)."""
    y = x - c
    t = s + y
    return t, (t - s) - y


def trilinear_pool_volume_grad_ordered(g, volume_shape, zyx, roi_b, valid):
    """(B, D, H, W, C) f32 gradient of `trilinear_pool` with respect to the
    volume in the order of the kernel `trilinear_pool_bwd`: each cell's
    entries ascending by entry (e = 8 * sample + corner), cut into chunks
    of BWD_CHUNK entries; each chunk's g * w summed in order, Kahan in f32,
    to s - c; a cell's chunk values added in chunk order, Kahan in f32 (a
    cell of one chunk takes its value as it is). Vectorised over chunks,
    one chunk position at a time. Rounding the result to the volume's
    dtype is the caller's (the kernel rounds once)."""
    B, D, H, W, C = volume_shape
    M = B * D * H * W
    dev = g.device
    out = torch.zeros((M, C), dtype=torch.float32, device=dev)
    cell, w = _corner_entries(zyx, roi_b, valid, volume_shape)
    ent = torch.nonzero(cell >= 0).squeeze(1)
    if ent.numel() == 0:
        return out.reshape(B, D, H, W, C)
    cells, order = torch.sort(cell[ent], stable=True)
    ent = ent[order]
    counts = torch.bincount(cells, minlength=M)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(ent.numel(), device=dev) - start[cells]
    nch = (counts + BWD_CHUNK - 1) // BWD_CHUNK
    choff = torch.cumsum(nch, 0) - nch
    chunk_id = choff[cells] + rank // BWD_CHUNK
    pos = rank % BWD_CHUNK
    gf = g.reshape(-1, C)
    n_chunks = int(nch.sum())
    s = torch.zeros((n_chunks, C), dtype=torch.float32, device=dev)
    c = torch.zeros_like(s)
    for t in range(min(BWD_CHUNK, int(counts.max()))):
        sel = torch.nonzero(pos == t).squeeze(1)
        ids, e = chunk_id[sel], ent[sel]
        x = gf[e // 8].float() * w[e][:, None]
        s[ids], c[ids] = _kahan(s[ids], c[ids], x)
    v = s - c
    one = torch.nonzero(nch == 1).squeeze(1)
    out[one] = v[choff[one]]
    multi = torch.nonzero(nch > 1).squeeze(1)
    acc = torch.zeros((multi.numel(), C), dtype=torch.float32, device=dev)
    comp = torch.zeros_like(acc)
    for k in range(int(nch.max())):
        live = torch.nonzero(nch[multi] > k).squeeze(1)
        acc[live], comp[live] = _kahan(acc[live], comp[live], v[choff[multi[live]] + k])
    out[multi] = acc - comp
    return out.reshape(B, D, H, W, C)


def trilinear_pool_grad(g, volume_shape, volume_dtype, zyx, roi_b, valid):
    """(B, D, H, W, C) gradient of `trilinear_pool` with respect to the
    volume, in `volume_dtype`: the plain `trilinear_pool_volume_grad`
    (f32, rounded once) for CPU tensors, the kernel `trilinear_pool_bwd`
    for CUDA tensors (g (R, S, C) in the volume's dtype; zyx, roi_b, valid
    as for `trilinear_pool`)."""
    if g.device.type == "cpu":
        return trilinear_pool_volume_grad(g, volume_shape, zyx, roi_b, valid).to(volume_dtype)
    if g.device.type != "cuda":
        raise ValueError(f"trilinear_pool_grad: unsupported device {g.device}")
    B, D, H, W, C = volume_shape
    R, S, three = zyx.shape
    if volume_dtype not in (torch.float32, torch.bfloat16) or zyx.dtype != torch.float32:
        raise TypeError(f"trilinear_pool_grad: volume {volume_dtype} / points {zyx.dtype}")
    if three != 3 or g.shape != (R, S, C) or valid.shape != (R, S) or roi_b.shape != (R,):
        raise ValueError(f"trilinear_pool_grad: bad shapes g {tuple(g.shape)} points "
                         f"{tuple(zyx.shape)} valid {tuple(valid.shape)} rois "
                         f"{tuple(roi_b.shape)} for volume {tuple(volume_shape)}")
    if (C % 8 or C > 2048 or bwd_key_count(volume_shape) >= 2**31 - 1
            or 8 * R * S >= 2**31 - 1):
        raise ValueError(f"trilinear_pool_grad: volume {tuple(volume_shape)} with {R}x{S} "
                         "samples: the kernel takes C a multiple of 8 up to 2048 and fewer "
                         "than 2^31 - 1 cell keys (`bwd_key_count`) and corner entries")
    for t in (zyx, roi_b, valid):
        if t.device != g.device:
            raise ValueError("trilinear_pool_grad: tensors on different devices")
    g = g.to(volume_dtype).contiguous()
    if g.data_ptr() % 16:
        g = g.clone()
    zyx = zyx.contiguous()
    valid_u8 = valid.to(torch.uint8).contiguous()
    roi_b32 = roi_b.to(torch.int32).contiguous()
    out = torch.empty(tuple(volume_shape), dtype=volume_dtype, device=g.device)
    lib = _lib()
    ws_bytes = lib.trilinear_pool_bwd_workspace(R * S, B, D, H, W, C)
    ws = torch.empty((ws_bytes,), dtype=torch.uint8, device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = lib.trilinear_pool_bwd(
        g.data_ptr(), int(volume_dtype == torch.bfloat16), B, D, H, W, C, zyx.data_ptr(),
        valid_u8.data_ptr(), roi_b32.data_ptr(), R, S, ws.data_ptr(), ws_bytes, out.data_ptr(),
        stream)
    if err != 0:
        raise RuntimeError(f"trilinear_pool_bwd kernel launch failed: cudaError {err}")
    trace.count("launch.trilinear_pool_grad")
    return out


class TrilinearPoolFunction(torch.autograd.Function):
    """`trilinear_pool` (kernel K4 on CUDA tensors) with the gradient of
    the volume (`trilinear_pool_grad`); apply(volume, zyx, roi_b, valid)."""

    @staticmethod
    def forward(ctx, volume, zyx, roi_b, valid):
        ctx.save_for_backward(zyx, roi_b, valid)
        ctx.volume_shape, ctx.volume_dtype = tuple(volume.shape), volume.dtype
        return trilinear_pool(volume, zyx, roi_b, valid)

    @staticmethod
    def backward(ctx, g):
        zyx, roi_b, valid = ctx.saved_tensors
        grad = None
        if ctx.needs_input_grad[0]:
            grad = trilinear_pool_grad(g, ctx.volume_shape, ctx.volume_dtype, zyx, roi_b, valid)
        return grad, None, None, None
