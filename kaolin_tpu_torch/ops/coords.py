"""Coordinate system conversions.

Port of ``kaolin_tpu/ops/coords.py``.
"""

import torch

__all__ = ['spherical2cartesian', 'cartesian2spherical']


def spherical2cartesian(azimuth, elevation, distance=None):
    """Convert spherical coordinates to cartesian.

    X toward the camera, Z up, Y right: elevation from the xy-plane toward
    +z, azimuth around z from +x toward +y.

    Args:
        azimuth: azimuth angles (radians), a tensor.
        elevation: elevation angles (radians), a tensor.
        distance: radii; default 1.

    Returns:
        (x, y, z) tensors.
    """
    if distance is None:
        distance = 1.
    z = torch.sin(elevation) * distance
    temp = torch.cos(elevation) * distance
    x = torch.cos(azimuth) * temp
    y = torch.sin(azimuth) * temp
    return x, y, z


def cartesian2spherical(x, y, z):
    """Convert cartesian coordinates to spherical.

    Returns:
        (azimuth, elevation, distance) tensors.
    """
    distance = torch.sqrt(x * x + y * y + z * z)
    elevation = torch.asin(z / distance)
    azimuth = torch.atan2(y, x)
    return azimuth, elevation, distance
