"""Small math helpers and the device / dtype policy of the reference:
float32 everywhere."""

from __future__ import annotations


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
    """The reference computes in float32 everywhere (`default` is the
    port's low-precision dtype, ignored here)."""
    return torch.float32


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


# ------------------------------------------------------ numpy host helpers
