"""ROI trilinear sampler: CUDA kernel K4 (`csrc/trilinear_pool.cu`) and
its plain PyTorch version (counterpart of `btcdet_tpu/ops/pallas_interp.py`).

Both sample the dense channels-last volume (B, D, H, W, C) at per-roi
points (R, S, 3) given as float voxel coords (z, y, x): 8-corner
trilinear weights, corners outside the volume weigh 0, invalid samples
are 0. The result is (R, S, C) float32 -- `pallas_interp._xla_reference_pool`
without the TPU kernel's 24x24-cell roi window.

`trilinear_pool` takes the plain version for CPU tensors only; a CUDA
tensor launches the kernel or raises. `TrilinearPoolFunction` adds the
gradient with respect to the volume (points and rois are constants, as
the JAX package's `pallas_interp.trilinear_pool_ad`): a scatter-add of the
output gradient over the 8 corner weights, in plain PyTorch on both
devices, as the JAX package runs it in XLA.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.common import trilinear_corners, trilinear_interpolate_dense
from . import kernel_build

# kernel launches made by the wrapper below (CPU calls take the plain
# version and are not counted)
launches = 0


def trilinear_pool_plain(volume, zyx, roi_b, valid):
    """8-corner gathers (`common.trilinear_interpolate_dense`) frame by
    frame, f32 accumulate; rois of no frame in [0, B) come out 0."""
    B, C = volume.shape[0], volume.shape[-1]
    R, S, _ = zyx.shape
    out = torch.zeros((R, S, C), dtype=torch.float32, device=volume.device)
    for b in range(B):
        sel = roi_b == b
        pts = zyx[sel].reshape(-1, 3)
        out[sel] = trilinear_interpolate_dense(volume[b], pts).reshape(-1, S, C)
    return torch.where(valid[..., None], out, torch.zeros((), device=out.device))


_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_int] * 5
             + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2)


def _lib():
    lib = kernel_build.load("trilinear_pool")
    if lib.trilinear_pool_fwd.argtypes is None:
        lib.trilinear_pool_fwd.argtypes = _ARGTYPES
        lib.trilinear_pool_fwd.restype = ctypes.c_int
    return lib


def trilinear_pool(volume, zyx, roi_b, valid):
    """(R, S, C) float32 trilinear samples.

    volume (B, D, H, W, C) f32 or bf16; zyx (R, S, 3) f32 voxel coords;
    roi_b (R,) batch index of each roi; valid (R, S) bool."""
    if volume.device.type == "cpu":
        return trilinear_pool_plain(volume, zyx, roi_b, valid)
    if volume.device.type != "cuda":
        raise ValueError(f"trilinear_pool: unsupported device {volume.device}")
    B, D, H, W, C = volume.shape
    R, S, three = zyx.shape
    if volume.dtype not in (torch.float32, torch.bfloat16) or zyx.dtype != torch.float32:
        raise TypeError(f"trilinear_pool: volume {volume.dtype} / points {zyx.dtype}")
    if three != 3 or valid.shape != (R, S) or roi_b.shape != (R,) or R > 65535:
        raise ValueError(f"trilinear_pool: bad shapes points {tuple(zyx.shape)} "
                         f"valid {tuple(valid.shape)} rois {tuple(roi_b.shape)}")
    for t in (zyx, roi_b, valid):
        if t.device != volume.device:
            raise ValueError("trilinear_pool: tensors on different devices")
    volume, zyx = volume.contiguous(), zyx.contiguous()
    valid_u8 = valid.to(torch.uint8).contiguous()
    roi_b32 = roi_b.to(torch.int32).contiguous()
    out = torch.empty((R, S, C), dtype=torch.float32, device=volume.device)
    if R == 0 or S == 0:
        return out
    stream = torch.cuda.current_stream(volume.device).cuda_stream
    err = _lib().trilinear_pool_fwd(
        volume.data_ptr(), int(volume.dtype == torch.bfloat16), B, D, H, W, C,
        zyx.data_ptr(), valid_u8.data_ptr(), roi_b32.data_ptr(), R, S, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"trilinear_pool kernel launch failed: cudaError {err}")
    global launches
    launches += 1
    return out



def trilinear_pool_volume_grad(g, volume_shape, zyx, roi_b, valid):
    """(B, D, H, W, C) float32 gradient of `trilinear_pool` with respect to
    the volume: each valid sample adds g * w to its in-volume corners."""
    B, D, H, W, C = volume_shape
    ok = valid & (roi_b >= 0)[:, None] & (roi_b < B)[:, None]
    base = roi_b.long()[:, None].expand(valid.shape) * (D * H * W)
    grad = torch.zeros((B * D * H * W, C), dtype=torch.float32, device=g.device)
    gf = g.float().reshape(-1, C)
    for lin, w in trilinear_corners(zyx, (D, H, W)):
        w = torch.where(ok, w, torch.zeros_like(w)).reshape(-1)
        grad.index_add_(0, (base + lin).reshape(-1), gf * w[:, None])
    return grad.reshape(B, D, H, W, C)


class TrilinearPoolFunction(torch.autograd.Function):
    """`trilinear_pool` (kernel K4 on CUDA tensors) with the gradient of
    the volume; apply(volume, zyx, roi_b, valid)."""

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
            grad = trilinear_pool_volume_grad(g, ctx.volume_shape, zyx, roi_b, valid)
            grad = grad.to(ctx.volume_dtype)
        return grad, None, None, None
