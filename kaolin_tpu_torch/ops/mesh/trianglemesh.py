"""Triangle mesh ops.

Port of ``kaolin_tpu/ops/mesh/trianglemesh.py`` (only :func:`face_normals`).
"""

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
