"""Generic mesh ops.

Port of ``kaolin_tpu/ops/mesh/mesh.py``: what the DIB-R step and
:class:`~kaolin_tpu_torch.rep.SurfaceMesh` need.
"""

import torch

__all__ = ['index_vertices_by_faces', 'compute_vertex_normals']


def index_vertices_by_faces(vertices_features, faces):
    """Gather per-vertex features into per-face-corner features.

    Args:
        vertices_features: ``(B, V, D)`` per-vertex features.
        faces: ``(F, face_size)`` int vertex indices.

    Returns:
        ``(B, F, face_size, D)`` gathered features.
    """
    if vertices_features.ndim != 3:
        raise ValueError(
            f"vertices_features must be (B, V, D), got "
            f"{tuple(vertices_features.shape)}")
    faces = torch.as_tensor(faces, device=vertices_features.device)
    return vertices_features[:, faces.long()]


def compute_vertex_normals(faces, face_normals, num_vertices=None):
    """Average per-face-corner normals onto vertices.

    Args:
        faces: ``(F, face_size)`` int indices.
        face_normals: ``(B, F, face_size, 3)`` pre-normalized normals.
        num_vertices: V (defaults to ``faces.max() + 1``).

    Returns:
        ``(B, V, 3)`` averaged (not re-normalized) vertex normals.
    """
    faces = torch.as_tensor(faces, device=face_normals.device).long()
    if num_vertices is None:
        num_vertices = int(faces.max()) + 1
    B = face_normals.shape[0]
    flat_idx = faces.reshape(-1)
    vertex_normals = torch.zeros((B, num_vertices, 3),
                                 dtype=face_normals.dtype,
                                 device=face_normals.device)
    vertex_normals = vertex_normals.index_add(
        1, flat_idx, face_normals.reshape(B, -1, 3))
    counts = torch.zeros((num_vertices,), dtype=face_normals.dtype,
                         device=face_normals.device)
    counts = counts.index_add(0, flat_idx, torch.ones_like(
        flat_idx, dtype=face_normals.dtype))
    return vertex_normals / torch.clamp(counts, min=1.)[None, :, None]
