"""Cartesian <-> cylinder / sphere coordinate transforms (counterpart of
`btcdet_tpu/utils/coords.py`, reference `btcdet/utils/coords_utils.py`).

    cylinder coords = (xydist, azimuth_deg, z)
    sphere coords   = (dist, azimuth_deg, elevation_deg)
    azimuth_deg     = atan2(-y, x) * 180 / pi
    elevation_deg   = atan2(z, xydist) * 180 / pi

Every function takes torch tensors or numpy arrays (trailing dim 3(+)
point arrays) and returns the same kind; the numpy path keeps the input
precision, which the host-side grid maps use in float64.
"""

from __future__ import annotations

import numpy as np
import torch


def _stack(parts):
    if torch.is_tensor(parts[0]):
        return torch.stack(parts, dim=-1)
    return np.stack(parts, axis=-1)


def _cat(parts):
    if torch.is_tensor(parts[0]):
        return torch.cat(parts, dim=-1)
    return np.concatenate(parts, axis=-1)


def _fns(arr):
    """(sqrt, atan2, cos, sin) of the array's library."""
    if torch.is_tensor(arr):
        return torch.sqrt, torch.atan2, torch.cos, torch.sin
    return np.sqrt, np.arctan2, np.cos, np.sin


def absxyz_to_cylinder(points):
    """(..., 3+C) cartesian -> (..., 3+C) cylinder (xydist, azi_deg, z)."""
    sqrt, atan2, _, _ = _fns(points)
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    out = _stack([sqrt(x * x + y * y), atan2(-y, x) * (180.0 / np.pi), z])
    if points.shape[-1] > 3:
        out = _cat([out, points[..., 3:]])
    return out


def absxyz_to_sphere(points):
    """(..., 3+C) cartesian -> (..., 3+C) sphere (dist, azi_deg, elev_deg)."""
    sqrt, atan2, _, _ = _fns(points)
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    xydist = sqrt(x * x + y * y)
    out = _stack([sqrt(x * x + y * y + z * z), atan2(-y, x) * (180.0 / np.pi),
                  atan2(z, xydist) * (180.0 / np.pi)])
    if points.shape[-1] > 3:
        out = _cat([out, points[..., 3:]])
    return out


def cylinder_to_absxyz(cyl_x, cyl_y, cyl_z):
    """cylinder (xydist, azi_deg, z) -> cartesian xyz."""
    _, _, cos, sin = _fns(cyl_x)
    rad = cyl_y * (np.pi / 180.0)
    return _stack([cyl_x * cos(rad), -cyl_x * sin(rad), cyl_z])


def sphere_to_absxyz(sph_x, sph_y, sph_z):
    """sphere (dist, azi_deg, elev_deg) -> cartesian xyz."""
    _, _, cos, sin = _fns(sph_x)
    azi = sph_y * (np.pi / 180.0)
    elev = sph_z * (np.pi / 180.0)
    xydist = sph_x * cos(elev)
    return _stack([xydist * cos(azi), -xydist * sin(azi), sph_x * sin(elev)])


def cartesian_to_occ(points, coord_type: str):
    if coord_type == "sphere":
        return absxyz_to_sphere(points)
    if coord_type == "cylinder":
        return absxyz_to_cylinder(points)
    if coord_type == "cartesian":
        return points
    raise ValueError(coord_type)


def occ_uvd_to_absxyz(u, v, d, coord_type: str):
    """Occ-grid coordinates back to cartesian (reference `uvd2absxyz`)."""
    if coord_type == "sphere":
        return sphere_to_absxyz(u, v, d)
    if coord_type == "cylinder":
        return cylinder_to_absxyz(u, v, d)
    if coord_type == "cartesian":
        return _stack([u, v, d])
    raise ValueError(coord_type)
