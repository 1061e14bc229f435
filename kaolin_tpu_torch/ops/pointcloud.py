"""Pointcloud ops.

Port of ``kaolin_tpu/ops/pointcloud.py``.
"""

from kaolin_tpu_torch._clip import clip

__all__ = ['center_points']


def center_points(points, normalize: bool = False, eps: float = 1e-6):
    """Center a batch of pointclouds at the mid-point of their AABB.

    If ``normalize``, also scale isotropically so points fit in [-0.5, 0.5].

    Args:
        points: ``(B, N, 3)`` pointclouds.
        normalize: scale to the unit cube after centering.
        eps: minimum extent used to avoid division by zero.

    Returns:
        ``(B, N, 3)`` centered (and optionally normalized) points.
    """
    if points.ndim != 3:
        raise ValueError(
            f"points must be (B, N, 3), got {tuple(points.shape)}")
    vmax = points.amax(dim=1, keepdim=True)
    vmin = points.amin(dim=1, keepdim=True)
    out = points - (vmax + vmin) / 2.
    if normalize:
        denom = clip((vmax - vmin).amax(dim=-1, keepdim=True), eps)
        out = out / denom
    return out
