"""Triangle mesh ops: areas, sampling, normals, subdivision.

Port of ``kaolin_tpu/ops/mesh/trianglemesh.py``.

* Sampling takes a ``torch.Generator`` (``generator=``) where the JAX
  package takes a key; without one it draws from the module generator of
  :mod:`kaolin_tpu_torch.ops.random`.  The draws are made on the
  generator's device and moved to the vertices'.  Faces are chosen in
  proportion to their areas by an inverse-CDF ``searchsorted`` over the
  float64 running sum of the areas.
* Loop subdivision computes its topology on the faces' device (one int64
  key per undirected edge, ``torch.unique``), where the JAX package uses
  host ``np.unique(axis=0)``: the same edges in the same order.  All vertex
  and alpha arithmetic is differentiable.
"""

import math

import numpy as np
import torch

from kaolin_tpu_torch._clip import clip
from kaolin_tpu_torch._device import entry_device
from kaolin_tpu_torch.ops import random as _random
from kaolin_tpu_torch.ops.batch import get_first_idx

__all__ = [
    'face_areas',
    'packed_face_areas',
    'sample_points',
    'packed_sample_points',
    'face_normals',
    'subdivide_trianglemesh',
]


def _base_face_areas(v0, v1, v2):
    """Areas from the three vertex positions (cross-product norm / 2)."""
    x1, x2, x3 = torch.split(v0 - v1, 1, dim=-1)
    y1, y2, y3 = torch.split(v1 - v2, 1, dim=-1)
    a = (x2 * y3 - x3 * y2) ** 2
    b = (x3 * y1 - x1 * y3) ** 2
    c = (x1 * y2 - x2 * y1) ** 2
    return torch.sqrt(a + b + c) * 0.5


def _base_sample_points_selected_faces(face_vertices, face_features=None,
                                       u=None, v=None):
    """Points (and features) at barycentric ``(1 - u, u (1 - v), u v)`` of
    the given faces; a uniform density needs ``u = sqrt(uniform)``."""
    fv0, fv1, fv2 = face_vertices
    w0 = 1. - u
    w1 = u * (1. - v)
    w2 = u * v
    points = w0 * fv0 + w1 * fv1 + w2 * fv2
    features = None
    if face_features is not None:
        ff0, ff1, ff2 = face_features
        features = w0 * ff0 + w1 * ff1 + w2 * ff2
    return points, features


def face_areas(vertices, faces):
    """Areas of each face of batched fixed-topology triangle meshes.

    Args:
        vertices: ``(B, V, 3)``.
        faces: ``(F, 3)`` int.

    Returns:
        ``(B, F)`` areas.
    """
    faces = torch.as_tensor(faces, device=vertices.device).long()
    fv = vertices[:, faces]  # (B, F, 3, 3)
    return _base_face_areas(fv[:, :, 0], fv[:, :, 1], fv[:, :, 2])[..., 0]


def packed_face_areas(vertices, first_idx_vertices, faces,
                      num_faces_per_mesh):
    """Areas of the faces of packed meshes.

    Args:
        vertices: packed ``(total_V, 3)``.
        first_idx_vertices: ``(B + 1,)`` host offsets into vertices.
        faces: packed ``(total_F, 3)`` (per-mesh local indices).
        num_faces_per_mesh: ``(B,)`` host array.

    Returns:
        packed ``(total_F,)`` areas.
    """
    first_idx_vertices = np.asarray(first_idx_vertices)
    num_faces_per_mesh = np.asarray(num_faces_per_mesh)
    vert_offset = torch.as_tensor(
        np.repeat(first_idx_vertices[:-1], num_faces_per_mesh),
        device=vertices.device)[:, None]
    global_faces = torch.as_tensor(faces, device=vertices.device).long() \
        + vert_offset
    fv = vertices[global_faces]  # (total_F, 3, 3)
    return _base_face_areas(fv[:, 0], fv[:, 1], fv[:, 2])[..., 0]


def _draw(generator, shape, dtype, device):
    """Uniforms in [0, 1) from ``generator`` (on its device), on ``device``."""
    gen = _random.default_generator() if generator is None else generator
    return torch.rand(shape, dtype=dtype, generator=gen,
                      device=gen.device).to(device)


def _choose_faces(areas, u):
    """Area-weighted face ids: ``u`` (uniform in [0, 1)) against the float64
    running sum of ``areas`` along the last dim."""
    cdf = torch.cumsum(areas.detach().double(), dim=-1)
    r = u * cdf[..., -1:]
    return torch.searchsorted(cdf, r, right=True).clamp_(
        max=areas.shape[-1] - 1)


def sample_points(vertices, faces, num_samples, areas=None,
                  face_features=None, generator=None, device=None):
    """Uniformly sample points (and interpolated features) on meshes.

    Face choice is area-weighted; within a face the sample takes the
    sqrt-warped barycentrics.  The draws (face choice, then u, then v) come
    from ``generator``, else from the module generator.

    Args:
        vertices: ``(B, V, 3)``.
        faces: ``(F, 3)`` int.
        num_samples: number of points per mesh.
        areas: optional precomputed ``(B, F)`` areas.
        face_features: optional ``(B, F, 3, D)`` per-corner features.
        generator: optional ``torch.Generator``.
        device: where the samples go (default: the device of a tensor
            ``vertices``, else the card).

    Returns:
        (points ``(B, num_samples, 3)``, face_choices ``(B, num_samples)``)
        or (points, features, face_choices) when ``face_features`` is given.
    """
    device = entry_device(device, vertices)
    vertices = torch.as_tensor(vertices, device=device)
    faces = torch.as_tensor(faces, device=device).long()
    B = vertices.shape[0]
    if areas is None:
        areas = face_areas(vertices, faces)
    dev = vertices.device
    face_choices = _choose_faces(areas, _draw(
        generator, (B, num_samples), torch.float64, dev))
    u = torch.sqrt(_draw(generator, (B, num_samples, 1), vertices.dtype,
                         dev))
    v = _draw(generator, (B, num_samples, 1), vertices.dtype, dev)
    bidx = torch.arange(B, device=dev)[:, None]
    sel = vertices[bidx[..., None], faces[face_choices]]  # (B, S, 3, 3)
    ff = None
    if face_features is not None:
        sel_ff = face_features[bidx, face_choices]          # (B, S, 3, D)
        ff = (sel_ff[:, :, 0], sel_ff[:, :, 1], sel_ff[:, :, 2])
    points, features = _base_sample_points_selected_faces(
        (sel[:, :, 0], sel[:, :, 1], sel[:, :, 2]), ff, u=u, v=v)
    if face_features is not None:
        return points, features, face_choices
    return points, face_choices


def packed_sample_points(vertices, first_idx_vertices, faces,
                         num_faces_per_mesh, num_samples, generator=None):
    """Uniformly sample points over packed meshes, one mesh after another
    from ``generator``.

    Returns:
        (points ``(B, num_samples, 3)``, face_choices ``(B, num_samples)``)
        with per-mesh *local* face indices.
    """
    first_idx_vertices = np.asarray(first_idx_vertices)
    num_faces_per_mesh = np.asarray(num_faces_per_mesh)
    first_idx_faces = get_first_idx(num_faces_per_mesh)
    B = num_faces_per_mesh.shape[0]
    dev = vertices.device
    faces = torch.as_tensor(faces, device=dev).long()
    all_areas = packed_face_areas(vertices, first_idx_vertices, faces,
                                  num_faces_per_mesh)
    points_out, choices_out = [], []
    for b in range(B):
        lo, hi = int(first_idx_faces[b]), int(first_idx_faces[b + 1])
        sub_faces = faces[lo:hi] + int(first_idx_vertices[b])
        face_choices = _choose_faces(all_areas[lo:hi], _draw(
            generator, (num_samples,), torch.float64, dev))
        fv = vertices[sub_faces[face_choices]]  # (S, 3, 3)
        u = torch.sqrt(_draw(generator, (num_samples, 1), vertices.dtype,
                             dev))
        v = _draw(generator, (num_samples, 1), vertices.dtype, dev)
        pts, _ = _base_sample_points_selected_faces(
            (fv[:, 0], fv[:, 1], fv[:, 2]), u=u, v=v)
        points_out.append(pts)
        choices_out.append(face_choices)
    return torch.stack(points_out), torch.stack(choices_out)

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
        normals = normals / clip(
            torch.linalg.norm(normals, dim=-1, keepdim=True), 1e-12)
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


def _loop_alpha(n):
    """Loop subdivision vertex weight for valence n (float64 tensor)."""
    alpha = (5.0 / 8 - (3.0 / 8 + 1.0 / 4 * torch.cos(2 * math.pi / n))
             ** 2) / n
    return torch.where(n == 3, 3. / 16., alpha)


def subdivide_trianglemesh(vertices, faces, iterations, alpha=None):
    """Loop subdivision with optional learnable per-vertex smoothing alpha.

    With ``alpha=None`` this is exact Loop subdivision; otherwise the vertex
    update is ``(1 - alpha) * v + alpha / n * sum(neighbors)`` and alpha is
    carried (averaged) to the new edge vertices, as in DMTet.

    Args:
        vertices: ``(B, V, 3)``.
        faces: ``(F, 3)`` int.
        iterations: number of subdivision rounds.
        alpha: optional ``(B, V)`` smoothing factors.

    Returns:
        (new_vertices ``(B, V', 3)``, new_faces ``(F * 4**it, 3)`` int64),
        on the device of ``vertices``.
    """
    dev = vertices.device
    faces = torch.as_tensor(faces, device=dev).long()
    init_alpha = alpha
    for _ in range(iterations):
        b, v = vertices.shape[0], vertices.shape[1]
        f = faces.shape[0]
        edges_sorted = torch.sort(
            faces[:, [[0, 1], [1, 2], [2, 0]]].reshape(-1, 2), dim=-1)[0]
        key, inverse_indices, counts = torch.unique(
            edges_sorted[:, 0] * v + edges_sorted[:, 1],
            return_inverse=True, return_counts=True)
        edges_ex2 = torch.stack([key // v, key % v], dim=-1)
        all_edges_face_idx = torch.arange(f, device=dev).repeat_interleave(3)

        # vertex valence and neighbour sums over the undirected edge list
        both_dir = torch.cat([edges_ex2, edges_ex2.flip(1)])
        n = torch.zeros(v, dtype=torch.float64, device=dev).index_add_(
            0, both_dir[:, 0], torch.ones(both_dir.shape[0],
                                          dtype=torch.float64, device=dev))
        n = n.reshape(-1, 1)
        if init_alpha is None:
            alpha = (_loop_alpha(n) * n)[None].to(vertices.dtype)
        else:
            alpha = torch.as_tensor(alpha, device=dev)
            if alpha.ndim == 2:
                alpha = alpha[..., None]

        nbr_sum = torch.zeros_like(vertices).index_add(
            1, both_dir[:, 0], vertices[:, both_dir[:, 1]])
        n_j = n.to(vertices.dtype)
        vertices_new = (1 - alpha) * vertices + alpha / n_j * nbr_sum

        edges_fx3 = inverse_indices.reshape(f, 3) + v
        mask_e = counts == 2

        # boundary edge points: midpoint of the two endpoints
        edge_pts = (vertices[:, edges_ex2[:, 0]] +
                    vertices[:, edges_ex2[:, 1]]) / 2.
        alpha_pts = (alpha[:, edges_ex2[:, 0]] +
                     alpha[:, edges_ex2[:, 1]]) / 2.

        # interior edge points: mean of the 6 vertices of the two adjacent
        # faces and the 2 endpoints (the Loop 3/8-3/8-1/8-1/8 rule)
        if bool(mask_e.any()):
            sel = mask_e[inverse_indices]   # interior face-edge slots
            groups = inverse_indices[sel]
            order = torch.sort(groups, stable=True)[1]
            face_pairs = all_edges_face_idx[sel][order].reshape(-1, 2)
            int_edge_ids = torch.nonzero(mask_e)[:, 0]
            int_edges = edges_ex2[int_edge_ids]                  # (E_int, 2)
            six = faces[face_pairs.reshape(-1)].reshape(-1, 6)
            idx8 = torch.cat([six, int_edges], dim=1).reshape(-1)  # E_int*8
            int_pts = vertices[:, idx8].reshape(b, -1, 8, 3).mean(dim=2)
            int_alpha = alpha[:, idx8].reshape(
                alpha.shape[0], -1, 8, 1).mean(dim=2)
            edge_pts = edge_pts.index_copy(1, int_edge_ids, int_pts)
            alpha_pts = alpha_pts.index_copy(1, int_edge_ids, int_alpha)

        alpha = torch.cat([alpha, alpha_pts], dim=1)
        vertices = torch.cat([vertices_new, edge_pts], dim=1)
        faces6 = torch.cat([faces, edges_fx3], dim=1)
        faces = faces6[:, [[1, 4, 3], [0, 3, 5], [2, 5, 4],
                           [5, 3, 4]]].reshape(-1, 3)
    return vertices, faces
