"""SPC point utilities: quantization, morton codes, octree from points.

Port of ``kaolin_tpu/ops/spc/points.py`` (the part on the SPC trace path;
trilinear interpolation, corners and dense octrees are still to port).

Conventions (``kaolin/csrc/spc_math.h:93-121``): the morton code
interleaves (x, y, z) with x in bit ``3i+2``, y in ``3i+1`` and z in ``3i``,
so a child's octant within its parent byte is ``x<<2 | y<<1 | z``.  torch
has int64, so a code (45 bits through level 15) is one int64 tensor; the
JAX package keeps it in numpy uint64 on the host.
"""

import numpy as np
import torch

from kaolin_tpu_torch.ops.spc.device import morton_i64

__all__ = ['quantize_points', 'points_to_morton', 'morton_to_points',
           'unbatched_points_to_octree', 'unbatched_points_to_octree_np']


def quantize_points(x, level):
    """Quantize [-1, 1] float coords to (..., 3) int16 grid coords at
    ``level`` (clipped to [0, 2^level - 1])."""
    res = 2 ** level
    qpts = torch.floor((x + 1.0) * (res / 2.0)).to(torch.int32)
    return torch.clamp(qpts, 0, res - 1).to(torch.int16)


def points_to_morton(points):
    """(N, 3) integer coords (< 2^16) -> (N,) int64 morton codes, on the
    points' device."""
    return morton_i64(torch.as_tensor(points))


def morton_to_points(morton):
    """(N,) morton codes -> (N, 3) int16 points."""
    m = torch.as_tensor(morton).to(torch.int64)
    x = torch.zeros_like(m)
    y = torch.zeros_like(m)
    z = torch.zeros_like(m)
    for i in range(16):
        x |= (m & (1 << (3 * i + 2))) >> (2 * i + 2)
        y |= (m & (1 << (3 * i + 1))) >> (2 * i + 1)
        z |= (m & (1 << (3 * i))) >> (2 * i)
    return torch.stack([x, y, z], dim=-1).to(torch.int16)


def unbatched_points_to_octree(points, level, sorted=False):
    """Octree bytes (uint8, root first) from (N, 3) integer coords in
    [0, 2^level), on the points' device.  Duplicates are allowed.

    Bottom-up: per level the sorted unique codes are grouped by parent and
    each parent's byte is the sum of its distinct child bits (== their OR).
    ``sorted`` is accepted for API parity and unused.
    """
    del sorted
    morton = torch.unique(points_to_morton(points))
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
    morton = np.unique(points_to_morton(np.asarray(points)).numpy())
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
