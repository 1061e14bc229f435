"""Triangle mesh -> SPC octree.

Port of ``kaolin_tpu/ops/conversions/trianglemesh.py`` (the SPC builders;
``trianglemeshes_to_voxelgrids`` is still to port).  The host builder
:func:`unbatched_mesh_to_spc` is numpy in float64, as in the JAX package,
and is the oracle of the device builder :func:`unbatched_mesh_to_spc_device`.
"""

import numpy as np
import torch

from kaolin_tpu_torch.ops.spc.device import (mesh_to_spc_device,
                                             pack_octree_device)
from kaolin_tpu_torch.ops.spc.points import (points_to_morton,
                                             unbatched_points_to_octree_np)

__all__ = ['unbatched_mesh_to_spc', 'unbatched_mesh_to_spc_device']


def unbatched_mesh_to_spc_device(face_vertices, level, cap=2 ** 21):
    """Conservative mesh voxelization on the device of ``face_vertices``.

    Args:
        face_vertices: (num_faces, 3, 3) float tensor in [-1, 1].
        level: target octree level (<= 15).
        cap: max surviving (voxel, triangle) proposals per level; rows past
            it are dropped silently (see :func:`~kaolin_tpu_torch.ops.spc.
            device.mesh_to_spc_device`).

    Returns:
        (octree uint8, points (num_voxels, 3) int16 in morton order,
        face_idx (num_voxels,) int64, bary (num_voxels, 2) float32), on the
        input's device — the same as the host builder.
    """
    face_vertices = torch.as_tensor(face_vertices)
    octree_p, counts, _, vox, tri, bary, n = mesh_to_spc_device(
        face_vertices.to(torch.float32), int(level), cap=int(cap))
    octree, nbytes = pack_octree_device(octree_p, counts, cap=int(cap))
    return (octree[:nbytes], vox[:n].to(torch.int16), tri[:n].to(torch.int64),
            bary[:n])


def unbatched_mesh_to_spc(face_vertices, level):
    """Conservative mesh voxelization on the host (numpy float64).

    Coarse to fine: each (voxel, triangle) proposal is split into its 8
    children and SAT-tested; at the leaf level voxels are deduplicated
    keeping the first triangle in (morton, tri) order.

    Args:
        face_vertices: (num_faces, 3, 3) triangle vertices in [-1, 1].
        level: target octree level.

    Returns:
        (octree uint8, points (num_voxels, 3) int16, face_idx (num_voxels,)
        int64, bary (num_voxels, 2) float32), CPU tensors.
    """
    fv = np.asarray(face_vertices, dtype=np.float64)
    T = fv.shape[0]
    vox = np.zeros((T, 3), dtype=np.int64)
    tri = np.arange(T, dtype=np.int64)
    offs = np.stack([(np.arange(8) >> 2) & 1, (np.arange(8) >> 1) & 1,
                     np.arange(8) & 1], axis=-1)
    for l in range(1, level + 1):
        vox = (vox[:, None] * 2 + offs[None]).reshape(-1, 3)
        tri = np.repeat(tri, 8)
        keep = _tri_aabb_sat(fv[tri], vox, l)
        vox, tri = vox[keep], tri[keep]

    morton = points_to_morton(vox).numpy()
    order = np.lexsort((tri, morton))
    morton, vox, tri = morton[order], vox[order], tri[order]
    uniq = np.concatenate([[True], morton[1:] != morton[:-1]])
    vox, tri = vox[uniq], tri[uniq]

    octree = unbatched_points_to_octree_np(vox, level)
    bary = _voxel_center_bary(fv[tri], vox, level)
    return (torch.as_tensor(octree), torch.as_tensor(vox.astype(np.int16)),
            torch.as_tensor(tri), torch.as_tensor(bary.astype(np.float32)))


def _tri_aabb_sat(tris, vox, level, slack=0.):
    """Triangle-AABB separating axis test (13 axes), float64 numpy.

    tris: (N, 3, 3) in [-1, 1]; vox: (N, 3) integer coords at ``level``.
    ``slack`` grows the box's half side by that fraction (to tell a
    borderline touch from a miss).  Mirrors ``mesh_to_spc_cuda.cu:96-159``.
    """
    r = 1.0 / (1 << level)
    center = vox * (2.0 * r) + r - 1.0
    v = tris - center[:, None, :]
    h = np.full(3, r * (1. + slack))
    e = np.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 1],
                  v[:, 0] - v[:, 2]], axis=1)
    ok = np.ones(tris.shape[0], dtype=bool)
    for a in range(3):
        ok &= ~((v[:, :, a].min(1) > h[a]) | (v[:, :, a].max(1) < -h[a]))
    n = np.cross(e[:, 0], e[:, 1])
    ok &= np.abs(np.sum(n * v[:, 0], axis=1)) <= np.abs(n) @ h
    for i in range(3):
        for a in range(3):
            axis = np.zeros(3)
            axis[a] = 1.
            cross = np.cross(e[:, i], axis)
            p = np.einsum('nj,nkj->nk', cross, v)
            rad = np.abs(cross) @ h
            ok &= ~((p.min(1) > rad) | (p.max(1) < -rad))
    return ok


def _voxel_center_bary(tris, vox, level):
    """Barycentric (u, v) of each voxel centre on its triangle, float64
    (``mesh_to_spc_cuda.cu:252-305``)."""
    r = 1.0 / (1 << level)
    center = vox * (2.0 * r) + r - 1.0
    v0 = tris[:, 1] - tris[:, 0]
    v1 = tris[:, 2] - tris[:, 0]
    v2 = center - tris[:, 0]
    d00 = np.sum(v0 * v0, axis=1)
    d01 = np.sum(v0 * v1, axis=1)
    d11 = np.sum(v1 * v1, axis=1)
    d20 = np.sum(v2 * v0, axis=1)
    d21 = np.sum(v2 * v1, axis=1)
    denom = d00 * d11 - d01 * d01
    denom = np.where(np.abs(denom) < 1e-20, 1e-20, denom)
    u = (d11 * d20 - d01 * d21) / denom
    v = (d00 * d21 - d01 * d20) / denom
    return np.stack([u, v], axis=-1)
