"""Generic mesh ops.

Port of ``kaolin_tpu/ops/mesh/mesh.py`` (only what the DIB-R step needs).
"""

import torch

__all__ = ['index_vertices_by_faces']


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
