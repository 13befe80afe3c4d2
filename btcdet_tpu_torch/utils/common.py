"""Small math helpers and the device / dtype policy (counterpart of
`btcdet_tpu/utils/common.py`)."""

from __future__ import annotations

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
