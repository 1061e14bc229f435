"""SPC point utilities: quantization, morton codes, octree from points,
corners, trilinear interpolation and dense octrees.

Port of ``kaolin_tpu/ops/spc/points.py``.  Interpolation is plain torch and
differentiable with respect to the coords and the corner features through
autograd (the JAX package differentiates its jnp the same way).

Conventions (``kaolin/csrc/spc_math.h:93-121``): the morton code
interleaves (x, y, z) with x in bit ``3i+2``, y in ``3i+1`` and z in ``3i``,
so a child's octant within its parent byte is ``x<<2 | y<<1 | z``.  torch
has int64, so a code (45 bits through level 15) is one int64 tensor; the
JAX package keeps it in numpy uint64 on the host.
"""

import numpy as np
import torch

from kaolin_tpu_torch._device import entry_device
from kaolin_tpu_torch.ops.spc.device import morton_i64

__all__ = ['quantize_points', 'points_to_morton', 'morton_to_points',
           'unbatched_points_to_octree', 'unbatched_points_to_octree_np',
           'points_to_corners', 'coords_to_trilinear',
           'coords_to_trilinear_coeffs', 'unbatched_interpolate_trilinear',
           'create_dense_spc']

# corner j of a voxel, and child octant j of a parent, sits at this offset
CORNERS = torch.tensor([[(j >> 2) & 1, (j >> 1) & 1, j & 1]
                        for j in range(8)], dtype=torch.int32)


def quantize_points(x, level):
    """Quantize [-1, 1] float coords to (..., 3) int16 grid coords at
    ``level`` (clipped to [0, 2^level - 1])."""
    res = 2 ** level
    qpts = torch.floor((x + 1.0) * (res / 2.0)).to(torch.int32)
    return torch.clamp(qpts, 0, res - 1).to(torch.int16)


def points_to_morton(points, device=None):
    """(N, 3) integer coords (< 2^16) -> (N,) int64 morton codes, on
    ``device`` (default: the points' device if a tensor, else the card)."""
    return morton_i64(torch.as_tensor(points,
                                      device=entry_device(device, points)))


def morton_to_points(morton, device=None):
    """(N,) morton codes -> (N, 3) int16 points, on ``device`` (default:
    the codes' device if a tensor, else the card)."""
    m = torch.as_tensor(morton, device=entry_device(device, morton)).to(
        torch.int64)
    x = torch.zeros_like(m)
    y = torch.zeros_like(m)
    z = torch.zeros_like(m)
    for i in range(16):
        x |= (m & (1 << (3 * i + 2))) >> (2 * i + 2)
        y |= (m & (1 << (3 * i + 1))) >> (2 * i + 1)
        z |= (m & (1 << (3 * i))) >> (2 * i)
    return torch.stack([x, y, z], dim=-1).to(torch.int16)


def unbatched_points_to_octree(points, level, sorted=False, device=None):
    """Octree bytes (uint8, root first) from (N, 3) integer coords in
    [0, 2^level), on ``device`` (default: the points' device if a tensor,
    else the card).  Duplicates are allowed.

    Bottom-up: per level the sorted unique codes are grouped by parent and
    each parent's byte is the sum of its distinct child bits (== their OR).
    ``sorted`` is accepted for API parity and unused.
    """
    del sorted
    morton = torch.unique(points_to_morton(points, device))
    levels = []
    for _ in range(level):
        parents = morton >> 3
        bits = (1 << (morton & 7)).to(torch.int32)
        uniq, inv = torch.unique_consecutive(parents, return_inverse=True)
        byte = torch.zeros(uniq.shape[0], dtype=torch.int32,
                           device=morton.device).index_add_(0, inv, bits)
        levels.append(byte.to(torch.uint8))
        morton = uniq
    if not levels:
        return torch.zeros(0, dtype=torch.uint8, device=morton.device)
    return torch.cat(levels[::-1])


def unbatched_points_to_octree_np(points, level, sorted=False):
    """Host numpy variant of :func:`unbatched_points_to_octree` (uint8
    numpy array), used by ``ops.conversions.unbatched_mesh_to_spc``."""
    del sorted
    morton = np.unique(points_to_morton(np.asarray(points), 'cpu').numpy())
    levels = []
    for _ in range(level, 0, -1):
        parents = morton >> 3
        child_bits = morton & 7
        uniq, inv = np.unique(parents, return_inverse=True)
        bytes_l = np.zeros(uniq.shape[0], dtype=np.uint8)
        np.bitwise_or.at(bytes_l, inv, (1 << child_bits).astype(np.uint8))
        levels.append(bytes_l)
        morton = uniq
    return np.concatenate(levels[::-1]) if levels else \
        np.zeros(0, dtype=np.uint8)


def points_to_corners(points, device=None):
    """The 8 corners of each point's voxel: (..., 3) integer coords ->
    (..., 8, 3), same dtype, on ``device`` (default: the points' device if
    a tensor, else the card); corner j is offset by
    ``(j>>2 & 1, j>>1 & 1, j & 1)``."""
    points = torch.as_tensor(points, device=entry_device(device, points))
    return points[..., None, :] + CORNERS.to(points.device, points.dtype)


def coords_to_trilinear(coords, points, level):
    """Deprecated alias of :func:`coords_to_trilinear_coeffs`."""
    import warnings
    warnings.warn("coords_to_trilinear is deprecated, "
                  "please use coords_to_trilinear_coeffs instead",
                  DeprecationWarning)
    return coords_to_trilinear_coeffs(coords, points, level)


def coords_to_trilinear_coeffs(coords, points, level):
    """Trilinear coefficients of (..., 3) float coords in [-1, 1] with
    respect to their voxel, given by (..., 3) integer ``points`` at
    ``level``: (..., 8), coefficient j for corner j of
    :func:`points_to_corners`."""
    x = (coords * 0.5 + 0.5) * (2 ** level) - points.to(coords.dtype)
    _x = 1.0 - x
    cx, cy, cz = x[..., 0], x[..., 1], x[..., 2]
    _cx, _cy, _cz = _x[..., 0], _x[..., 1], _x[..., 2]
    return torch.stack([_cx * _cy * _cz, _cx * _cy * cz, _cx * cy * _cz,
                        _cx * cy * cz, cx * _cy * _cz, cx * _cy * cz,
                        cx * cy * _cz, cx * cy * cz], dim=-1)


def unbatched_interpolate_trilinear(coords, pidx, point_hierarchy, trinkets,
                                    feats, level):
    """Trilinearly interpolate corner features at sample coords.

    Args:
        coords: (N, k, 3) float coords in [-1, 1].
        pidx: (N,) int indices into ``point_hierarchy`` (global, as
            :func:`~kaolin_tpu_torch.ops.spc.unbatched_query` and the ray
            traces return them); -1 entries give zeros.
        point_hierarchy: (num_points, 3) int coords.
        trinkets: (num_points, 8) int corner indices, level-local: they
            index the ``level`` slice of the dual hierarchy, which is what
            ``feats`` holds.
        feats: (num_corners, D) corner features of that slice.
        level: octree level of the samples.

    Returns:
        (N, k, D) interpolated features.
    """
    valid = pidx >= 0
    safe = torch.clamp(pidx, min=0).long()
    coeffs = coords_to_trilinear_coeffs(
        coords, point_hierarchy[safe][:, None, :], level)      # (N, k, 8)
    corner_feats = feats[trinkets[safe].long()]                  # (N, 8, D)
    out = torch.einsum('nkc,ncd->nkd', coeffs.to(feats.dtype), corner_feats)
    return torch.where(valid[:, None, None], out, 0.)


def create_dense_spc(level, device=None):
    """A fully dense octree of ``level``: (octree uint8 on ``device``
    (default: the card), lengths (1,) int32 CPU tensor)."""
    num_bytes = sum(8 ** lv for lv in range(level))
    octree = torch.full((num_bytes,), 255, dtype=torch.uint8,
                        device=entry_device(device))
    return octree, torch.tensor([num_bytes], dtype=torch.int32)
