"""Generic mesh ops: indexing, adjacency, laplacian, vertex normals.

Port of ``kaolin_tpu/ops/mesh/mesh.py``.  The JAX package deduplicates
edges on the host (``np.unique(axis=0)``); here they are deduplicated on
the faces' device through one int64 key ``i * V + j`` per directed edge,
whose sorted order is ``np.unique``'s lexicographic order of the pairs.
"""

import torch

from kaolin_tpu_torch._device import entry_device

__all__ = ['index_vertices_by_faces', 'adjacency_matrix',
           'uniform_laplacian', 'compute_vertex_normals']


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


def _unique_edges(faces, num_vertices=None):
    """All directed edges (i -> j and j -> i) of the faces, deduplicated,
    in lexicographic order: ``(E, 2)`` int64 on the faces' device."""
    faces = torch.as_tensor(faces).long()
    if num_vertices is None:
        num_vertices = int(faces.max()) + 1 if faces.numel() else 0
    rolled = torch.roll(faces, 1, dims=-1)
    i = torch.cat([faces.reshape(-1), rolled.reshape(-1)])
    j = torch.cat([rolled.reshape(-1), faces.reshape(-1)])
    key = torch.unique(i * num_vertices + j)
    return torch.stack([key // num_vertices, key % num_vertices], dim=-1)


def adjacency_matrix(num_vertices, faces, sparse=True, device=None):
    """Vertex adjacency matrix of a mesh.

    ``sparse=True`` returns a coalesced ``torch.sparse_coo_tensor`` (its
    indices in lexicographic order); ``sparse=False`` a dense ``(V, V)``
    float32 tensor.  On ``device`` (default: the device of a tensor
    ``faces``, else the card).
    """
    device = entry_device(device, faces)
    indices = _unique_edges(torch.as_tensor(faces, device=device),
                            num_vertices)
    values = torch.ones(indices.shape[0], dtype=torch.float32,
                        device=device)
    if sparse:
        return torch.sparse_coo_tensor(
            indices.t(), values, (num_vertices, num_vertices),
            check_invariants=False).coalesce()
    adj = torch.zeros((num_vertices, num_vertices), dtype=torch.float32,
                      device=device)
    adj[indices[:, 0], indices[:, 1]] = 1.
    return adj


def _edge_degrees(indices, num_vertices, dtype):
    return torch.zeros(num_vertices, dtype=dtype,
                       device=indices.device).index_add_(
        0, indices[:, 0], torch.ones(indices.shape[0], dtype=dtype,
                                     device=indices.device))


def uniform_laplacian(num_vertices, faces, device=None):
    """Uniform (combinatorial) Laplacian ``L = A / deg - I``, dense
    ``(V, V)`` float32; rows of isolated vertices are 0.  On ``device``
    (default: the device of a tensor ``faces``, else the card)."""
    device = entry_device(device, faces)
    indices = _unique_edges(torch.as_tensor(faces, device=device),
                            num_vertices)
    deg = _edge_degrees(indices, num_vertices, torch.float32)
    safe_deg = torch.where(deg > 0, deg, 1.)
    L = torch.zeros((num_vertices, num_vertices), dtype=torch.float32,
                    device=device)
    L[indices[:, 0], indices[:, 1]] = 1. / safe_deg[indices[:, 0]]
    L -= torch.diag((deg > 0).to(torch.float32))
    return L


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
