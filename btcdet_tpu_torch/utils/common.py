"""Small math helpers and the device / dtype policy (counterpart of
`btcdet_tpu/utils/common.py`)."""

from __future__ import annotations

import contextlib
import logging
import os

import numpy as np
import torch


def resolve_device(device=None, local_rank: int | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (explicitly or by default) and
    no card is present -- there is no silent CPU fallback. A rank of a
    data-parallel run (`local_rank`) asking for "cuda" gets
    cuda:{local_rank}, modulo the visible devices (ranks that share a
    device do so over gloo; `parallel.init_dist` refuses it for NCCL)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type == "cuda" and dev.index is None and local_rank is not None:
        dev = torch.device("cuda", int(local_rank) % torch.cuda.device_count())
    return dev


def activation_dtype(default=torch.bfloat16) -> torch.dtype:
    """Activation dtype of the low-precision compute paths (sparse-conv
    inputs, BEV map, conv pyramid, ConvHead). `BTCDET_F32=1` forces
    float32 everywhere, as in the JAX package."""
    if os.environ.get("BTCDET_F32"):
        return torch.float32
    return default


@contextlib.contextmanager
def float32_everywhere():
    """Float32 activations in the port (`BTCDET_F32=1`) and no TF32 in
    cuBLAS or cuDNN, for the duration."""
    old = os.environ.get("BTCDET_F32")
    os.environ["BTCDET_F32"] = "1"
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        if old is None:
            del os.environ["BTCDET_F32"]
        else:
            os.environ["BTCDET_F32"] = old


LECUN_TRUNC = 0.87962566103423978   # std of a unit normal truncated at +-2


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator=None) -> torch.Tensor:
    """flax's default kernel init, the JAX package's: a normal of variance
    1 / fan_in truncated at 2 sigma, in place."""
    std = (1.0 / fan_in) ** 0.5 / LECUN_TRUNC
    with torch.no_grad():
        return torch.nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                           generator=generator)


def jax_default_init_(module: torch.nn.Module) -> None:
    """The JAX package's default init (flax's), drawn over the layers'
    own draws: the kernels of the torch conv and linear layers of `module`,
    and of its dense convs in other layouts (an `out_axis` attribute names
    their output axis), lecun normal, their biases zero. A layer that sets
    `own_init` keeps its draw (the JAX package's std-0.001 layers); one
    that sets `prior_bias` keeps its bias (a focal prior). The draws come
    from a generator of torch's initial seed, so they repeat under
    `torch.manual_seed` and leave the global stream where it was."""
    nn = torch.nn
    gen = torch.Generator().manual_seed(torch.initial_seed())
    for m in module.modules():
        if getattr(m, "own_init", False):
            continue
        if isinstance(m, (nn.ConvTranspose1d, nn.ConvTranspose2d, nn.ConvTranspose3d)):
            out = m.weight.shape[1]
        elif isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.Linear)):
            out = m.weight.shape[0]
        elif hasattr(m, "out_axis"):
            out = m.weight.shape[m.out_axis]
        else:
            continue
        lecun_normal_(m.weight, m.weight.numel() // out, gen)
        if getattr(m, "bias", None) is not None and not getattr(m, "prior_bias", False):
            nn.init.zeros_(m.bias)


def limit_period(val, offset: float = 0.5, period: float = np.pi):
    """Wrap `val` into [-offset*period, (1-offset)*period)."""
    return val - torch.floor(val / period + offset) * period


def rotation_matrix_z(angle: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation about +z in the TRANSPOSED convention
    [[c, s, 0], [-s, c, 0], [0, 0, 1]], built for `p @ R` (reference
    `common_utils.rotate_points_along_z`)."""
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    rot = torch.stack([c, s, zero, -s, c, zero, zero, zero, one], dim=-1)
    return rot.reshape(angle.shape + (3, 3))


def rotate_points_along_z(points: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """points (B, N, 3 + C) rotated by angle (B,): p' = p @ R."""
    rot = rotation_matrix_z(angle)
    xyz = torch.matmul(points[..., :3], rot)
    if points.shape[-1] > 3:
        return torch.cat([xyz, points[..., 3:]], dim=-1)
    return xyz


def trilinear_corners(zyx: torch.Tensor, dhw):
    """The 8 corners of trilinear samples at float voxel coords zyx (..., 3)
    in a (D, H, W) grid: a list of (linear cell index, clamped into the
    grid, and weight, 0 for corners outside the grid)."""
    D, H, W = dhw
    z, y, x = zyx[..., 0], zyx[..., 1], zyx[..., 2]
    z0, y0, x0 = torch.floor(z), torch.floor(y), torch.floor(x)
    zi0, yi0, xi0 = z0.long(), y0.long(), x0.long()
    out = []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                zi, yi, xi = zi0 + dz, yi0 + dy, xi0 + dx
                inb = (zi >= 0) & (zi < D) & (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
                w = (torch.abs(1.0 - torch.abs(z - z0 - dz))
                     * torch.abs(1.0 - torch.abs(y - y0 - dy))
                     * torch.abs(1.0 - torch.abs(x - x0 - dx)))
                lin = (zi.clamp(0, D - 1) * H + yi.clamp(0, H - 1)) * W + xi.clamp(0, W - 1)
                out.append((lin, torch.where(inb, w, torch.zeros_like(w))))
    return out


def trilinear_interpolate_dense(vol: torch.Tensor, zyx: torch.Tensor) -> torch.Tensor:
    """vol (D, H, W, C); zyx (N, 3) float voxel coords -> (N, C). Corners
    outside the volume weigh zero (no edge clamping)."""
    D, H, W, C = vol.shape
    flat = vol.reshape(-1, C)
    out = 0.0
    for lin, w in trilinear_corners(zyx, (D, H, W)):
        out = out + flat[lin].float() * w[:, None]
    return out


def get_voxel_centers(voxel_coords: torch.Tensor, downsample_times, voxel_size,
                      point_cloud_range) -> torch.Tensor:
    """voxel_coords (..., 3) int (z, y, x) -> (..., 3) float32 xyz centres:
    (c + 0.5) * (voxel_size * downsample_times) + the range's origin."""
    dev = voxel_coords.device
    xyz = voxel_coords.flip(-1).float()
    vsz = (torch.tensor(voxel_size, dtype=torch.float32, device=dev)
           * torch.tensor(downsample_times, dtype=torch.float32, device=dev))
    origin = torch.tensor(point_cloud_range[:3], dtype=torch.float32, device=dev)
    return (xyz + 0.5) * vsz + origin


def bilinear_interpolate(im: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """im (H, W, C); x, y (N,) float pixel coords -> (N, C): the four
    neighbours clamped into the image, weighted by their distances
    (reference `common_utils.bilinear_interpolate_torch`)."""
    return bilinear_interpolate_batched(im[None], x[None], y[None])[0]


def bilinear_interpolate_batched(im: torch.Tensor, x: torch.Tensor,
                                 y: torch.Tensor) -> torch.Tensor:
    """`bilinear_interpolate` of every frame in one call: im (B, H, W, C);
    x, y (B, N) -> (B, N, C)."""
    B, H, W, C = im.shape
    flat = im.reshape(B * H * W, C)
    base = (torch.arange(B, device=im.device) * (H * W))[:, None]
    x0, y0 = torch.floor(x).long(), torch.floor(y).long()
    x1, y1 = x0 + 1, y0 + 1
    x0c, x1c = x0.clamp(0, W - 1), x1.clamp(0, W - 1)
    y0c, y1c = y0.clamp(0, H - 1), y1.clamp(0, H - 1)
    wa = ((x1 - x) * (y1 - y))[..., None]
    wb = ((x1 - x) * (y - y0))[..., None]
    wc = ((x - x0) * (y1 - y))[..., None]
    wd = ((x - x0) * (y - y0))[..., None]

    def at(yy, xx):
        return flat[base + yy * W + xx]

    return at(y0c, x0c) * wa + at(y1c, x0c) * wb + at(y0c, x1c) * wc + at(y1c, x1c) * wd


# ------------------------------------------------------ numpy host helpers

def limit_period_np(val, offset: float = 0.5, period: float = np.pi):
    """`limit_period` in numpy."""
    return val - np.floor(val / period + offset) * period


def rotation_matrix_z_np(angle: np.ndarray) -> np.ndarray:
    """`rotation_matrix_z` in numpy, in the input's dtype."""
    c, s = np.cos(angle), np.sin(angle)
    one, zero = np.ones_like(c), np.zeros_like(c)
    rot = np.stack([c, s, zero, -s, c, zero, zero, zero, one], axis=-1)
    return rot.reshape(angle.shape + (3, 3))


def rotate_points_along_z_np(points, angle) -> np.ndarray:
    """`rotate_points_along_z` in numpy (the host data pipeline's): points
    (B, N, 3 + C) rotated by angle (B,), p' = p @ R."""
    points, angle = np.asarray(points), np.asarray(angle)
    xyz = np.matmul(points[..., :3], rotation_matrix_z_np(angle))
    if points.shape[-1] > 3:
        return np.concatenate([xyz, points[..., 3:]], axis=-1)
    return xyz


def create_logger(log_file=None, log_level=logging.INFO, rank: int = 0) -> logging.Logger:
    """The package's logger: to the console, and to `log_file` (in place of
    an earlier call's file) when given. A rank other than 0 of a
    data-parallel run logs errors only, to the console."""
    logger = logging.getLogger("btcdet_tpu_torch")
    logger.setLevel(log_level if rank == 0 else logging.ERROR)
    if rank != 0:
        log_file = None
    formatter = logging.Formatter("%(asctime)s  %(levelname)5s  %(message)s")
    for h in [h for h in logger.handlers if isinstance(h, logging.FileHandler)]:
        logger.removeHandler(h)
        h.close()
    if not logger.handlers:
        console = logging.StreamHandler()
        console.setFormatter(formatter)
        logger.addHandler(console)
    if log_file is not None:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    logger.propagate = False
    return logger
