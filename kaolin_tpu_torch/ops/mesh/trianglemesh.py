"""Triangle mesh ops.

Port of ``kaolin_tpu/ops/mesh/trianglemesh.py`` (:func:`face_normals` and
the vertex subdivision of the voxelization).
"""

import numpy as np
import torch

__all__ = ['face_normals']


def face_normals(face_vertices, unit=False):
    """Face normals of triangle meshes from per-face vertex positions.

    Args:
        face_vertices: ``(B, F, 3, 3)``.
        unit: normalize to unit length (the norm is floored at 1e-12).

    Returns:
        ``(B, F, 3)`` normals.
    """
    if face_vertices.shape[-2:] != (3, 3):
        raise ValueError(
            f"face_vertices must be (..., 3, 3), got "
            f"{tuple(face_vertices.shape)}")
    v0 = face_vertices[..., 0, :]
    v1 = face_vertices[..., 1, :]
    v2 = face_vertices[..., 2, :]
    normals = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)
    if unit:
        normals = normals / torch.clamp(
            torch.linalg.norm(normals, dim=-1, keepdim=True), min=1e-12)
    return normals


def _unbatched_subdivide_vertices(vertices, faces, resolution):
    """Midpoint-subdivide triangles until every edge is shorter than the
    voxel threshold of ``resolution``; returns only the deduplicated,
    sorted vertices, as a tensor on the device of a tensor ``vertices``
    (the CPU for a numpy one).

    Host numpy, as in the JAX package: the output size depends on the data.
    """
    assert resolution > 1
    device = vertices.device if torch.is_tensor(vertices) else 'cpu'
    vertices = np.asarray(torch.as_tensor(vertices).cpu())
    faces = np.asarray(torch.as_tensor(faces).cpu())
    min_edge_length = ((resolution - 1) / (resolution ** 2)) ** 2
    v1 = vertices[faces[:, 0]]
    v2 = vertices[faces[:, 1]]
    v3 = vertices[faces[:, 2]]
    while True:
        e1 = ((v1 - v2) ** 2).sum(axis=1)
        e2 = ((v2 - v3) ** 2).sum(axis=1)
        e3 = ((v3 - v1) ** 2).sum(axis=1)
        keep = np.maximum(np.maximum(e1, e2), e3) > min_edge_length
        if not keep.any():
            break
        v1, v2, v3 = v1[keep], v2[keep], v3[keep]
        v4 = (v1 + v3) / 2
        v5 = (v1 + v2) / 2
        v6 = (v2 + v3) / 2
        vertices = np.unique(np.concatenate([vertices, v4, v5, v6]), axis=0)
        v1 = np.concatenate([v1, v2, v4, v3])
        v2 = np.concatenate([v4, v5, v5, v4])
        v3 = np.concatenate([v5, v6, v6, v6])
    return torch.as_tensor(vertices, device=device)
